"""``chip_smoke.py``'s phase 18 (the flagship sharded over a (1,2,2) mesh
of four ranks, its sharded snapshot, and a fresh launch restoring it
onto (1,2,2), (2,1,2) and a dense Trainer) rehearsed on four CPU ranks
over the local gloo group at a tiny f32 width, as the card runs it at
the flagship's. The phase's own checks raise on any miss."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from grit_tpu_torch.models import llama as pllama


def test_chip_smoke_mesh_phase_rehearsal(tmp_path):
    """``chip_smoke.phase_mesh``, the card's phase 18, on four CPU ranks at
    a tiny f32 width: sharded losses against dense, the manifest's named
    chunks, the bitwise (1,2,2) restore and the (2,1,2) and dense ones,
    every restored leaf against the source's at the cut, exact
    all-reduces of four kinds, every collective on the ranks' device."""
    cfg = pllama.LlamaConfig.tiny(dim=128, n_layers=4, n_heads=8,
                                  n_kv_heads=4, dtype=torch.float32,
                                  vocab_size=32000)
    got = chip_smoke.phase_mesh(torch, str(tmp_path), "cpu", seed=0,
                                device="cpu", cfg=cfg, shape=(2, 64))
    assert max(got["loss_gaps"]) < chip_smoke.MESH_LOSS_BOUND
    # The step's collectives, counted by the local gloo group itself:
    # FSDP's gather and reduce-scatter, the tensor-parallel sums.
    assert set(got["collectives"]) >= {"all_gather cpu", "all_reduce cpu",
                                       "reduce_scatter cpu"}
    # Each rank holds a shard of the state; replicated leaves on every rank.
    assert max(got["state_bytes"]) < got["dense_state_bytes"] <= sum(
        got["state_bytes"])


def _planted(kind: str, x: torch.Tensor) -> torch.Tensor:
    y = x.clone()
    flat = y.view(-1)
    if kind == "word":        # one bf16 element's bits changed
        flat.view(torch.int16)[5000] ^= 1
    elif kind == "swap":      # two elements of one block swapped
        flat[[10, 11]] = flat[[11, 10]]
    elif kind == "blocks":    # two whole 4096-word blocks swapped
        a, b = flat[:8192].clone(), flat[8192:16384].clone()
        flat[:8192], flat[8192:16384] = b, a
    elif kind == "shape":     # the same bytes in another shape
        y = y.reshape(x.shape[1], x.shape[0])
    return y


@pytest.mark.parametrize("kind", ["word", "swap", "blocks", "shape"])
def test_state_fingerprint_sees_a_misplaced_shard(kind):
    """Phase 18 holds each restored leaf to the source's at the cut by
    ``chip_smoke._fingerprint``: equal bytes give equal digests, and a
    changed word, two swapped words, two swapped blocks (a shard put in
    another's place) or another shape each change it."""
    x = torch.randn(8, 4096, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    assert chip_smoke._fingerprint(torch, x.clone()) == \
        chip_smoke._fingerprint(torch, x)
    assert chip_smoke._fingerprint(torch, _planted(kind, x)) != \
        chip_smoke._fingerprint(torch, x)
