"""``chip_smoke.py``'s phase 19 (the bench MoE expert-parallel by
``MOE_LLAMA_RULES`` over a (1,2,2) mesh of four ranks, its sharded
snapshot restored by a fresh launch onto (1,2,2), (2,1,2) and one device;
the flagship's and the MoE's serving grids sharded by ``KV_CACHE_RULES``,
their snapshots restored onto (1,2,2), (1,1,4) and one device) rehearsed
on four CPU ranks over the local gloo group at tiny f32 widths, inside
phase 18's two launches, as the card runs it at the full widths. The
phase's own checks raise on any miss."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from grit_tpu_torch.models import llama as pllama
from grit_tpu_torch.models import moe_llama as pmoe

TINY = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
            dtype=torch.float32)


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    moe = pmoe.MoeLlamaConfig.tiny(**TINY, top_k=2, vocab_size=512)
    ep = chip_smoke.ep_config(
        torch, moe_cfg=moe, shape=(4, 32),
        flagship={"cfg": pllama.LlamaConfig.tiny(**TINY, vocab_size=512),
                  "slots": 4, "max_len": 64, "temperature": 1.0,
                  "prompts": (20, 14, 5, 3), "buckets": (16, 32)},
        moe_grid={"cfg": moe, "slots": 4, "max_len": 64,
                  "temperature": 0.0, "prompts": (12, 9, 5, 3),
                  "buckets": (16, 32)})
    cfg = pllama.LlamaConfig.tiny(**TINY, vocab_size=512)
    return chip_smoke.phase_mesh(torch, str(tmp_path_factory.mktemp("ep")),
                                 "cpu", seed=0, device="cpu", cfg=cfg,
                                 shape=(2, 32), ep=ep)


def test_chip_smoke_ep_phase_rehearsal(phase):
    """Sharded MoE losses against dense within the phase's bound, the
    sharded step's collectives on the ranks' device, each rank holding a
    shard of the MoE state, the drops counted over the whole batch."""
    ep = phase["ep"]
    assert max(ep["loss_gaps"]) < chip_smoke.MESH_LOSS_BOUND
    assert set(ep["collectives"]) >= {"all_gather cpu", "all_reduce cpu",
                                      "reduce_scatter cpu"}
    assert max(ep["state_bytes"]) < ep["dense_state_bytes"] <= sum(
        ep["state_bytes"])
    assert 0.0 <= ep["drops"]["dense"] < 1.0
    assert abs(ep["drops"]["sharded"] - ep["drops"]["dense"]) < 0.05


@pytest.mark.parametrize("grid", ["flagship", "moe"])
def test_chip_smoke_ep_phase_grids(phase, grid):
    """Each grid decoded every round on the mesh (its tokens checked
    against one device's and its restores' by the phase itself)."""
    got = phase["ep"]["grids"][grid]
    assert got["tokens"] >= chip_smoke.GRID_ROUNDS * 4
    assert set(got["restore_s"]) == {"same", "other", "dense"}
    assert got["min_margin"] >= 0.0


def _experts_swapped(w: torch.Tensor) -> torch.Tensor:
    """``w`` (L, E, dim, hidden) with the two halves of its experts (the
    shards of a two-way split over ``model``) put in each other's place."""
    e = w.shape[1] // 2
    return torch.cat([w[:, e:], w[:, :e]], dim=1)


def test_state_digest_sees_a_misplaced_expert_shard():
    """Phase 19 holds each restored leaf to the source's at the cut by
    ``chip_smoke._fingerprint`` of the whole tensor: ``w_in`` reassembled
    from its shards in their places digests as the source's, and with its
    two expert shards swapped (the same bytes, a shard in the other's
    place) it does not."""
    w = torch.randn(2, 4, 64, 96, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    shards = list(w.chunk(2, dim=1))
    whole = torch.cat(shards, dim=1)
    assert chip_smoke._fingerprint(torch, whole) == \
        chip_smoke._fingerprint(torch, w)
    assert chip_smoke._fingerprint(torch, _experts_swapped(w)) != \
        chip_smoke._fingerprint(torch, w)
