"""Stateful serving engines: the lock-step and the continuous-batching engine.

Counterpart of ``grit_tpu/models/serving.py``. A serving pod's migratable
state is its decode state, not an optimizer: the KV cache, each
sequence's position, its sampler RNG stream, its last token and its count
of emitted tokens. Each engine keeps all of it in one tree
(``engine.state``) whose leaf names, shapes and dtypes are the JAX
engine's, so either package restores the other's serving snapshot leaf
for leaf::

    InferenceEngine.state                 ContinuousBatchingEngine.state
      cache: k, v (L, B, max_len, KVH, hd)  cache: k, v (L, n_slots, max_len,
             length int32 ()                       KVH, hd); length (unused)
      last_token int32 (B, 1)               lengths int32 (n_slots,)
      rng uint32 (2,)                       active bool (n_slots,)
      n_generated int32 ()                  last_token int32 (n_slots, 1)
                                            rngs uint32 (n_slots, 2)
                                            n_generated int32 (n_slots,)

The KV cache (and the lock-step engine's ``last_token``, which the next
step feeds back) lives on the engine's device; the bookkeeping lives on
the host, as the trainer keeps its step, so admission, capacity checks
and sampling seeds need no device sync. The continuous-batching step
brings its tokens to the host once per round, as the reference does.

**RNG leaves.** The JAX engines hold threefry keys. The port keeps the
leaves and fills the two words with its own encoding of the same facts,
``(seed, stream id)``: stream 0 for the lock-step engine, slot ``i`` for
a fresh grid and ``n_slots + submissions`` for an admitted prompt, the
counterparts of ``PRNGKey(seed)`` and ``fold_in(PRNGKey(seed), i)``. A
step samples by Gumbel-max with noise from a ``torch.Generator`` on the
engine's device seeded by the key and the stream's ``n_generated``, so a
sampled continuation is bit-identical within the port; across the two
frameworks only greedy tokens can agree.

Engines given no device run on the current CUDA device and raise without
one (pass ``device="cpu"`` explicitly).
"""

from __future__ import annotations

import contextlib
import hashlib
import struct
from dataclasses import dataclass

import torch

from grit_tpu_torch.device.placement import resolve_device
from grit_tpu_torch.device.quiesce import quiesce
from grit_tpu_torch.device.snapshot import (
    SnapshotManifest,
    restore_snapshot,
    write_snapshot,
)
from grit_tpu_torch.models import llama

_WORD = 1 << 32


def stream_key(seed: int, stream: int) -> list[int]:
    """The two uint32 words of an RNG leaf: ``(seed, stream id)``."""
    if not (0 <= seed < _WORD and 0 <= stream < _WORD):
        raise ValueError(f"seed {seed} and stream {stream} must each fit "
                         "in 32 bits")
    return [seed, stream]


def sample_seed(key: list[int], n_generated: int) -> int:
    """The generator seed of a stream's ``n_generated``-th sample."""
    digest = hashlib.sha256(struct.pack("<3I", *key, n_generated)).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _gumbel(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Gumbel(0, 1) noise from a generator seeded with ``seed``: adding it
    to logits and taking the argmax samples their softmax."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


def _on(device: torch.device):
    """Make ``device`` current in the calling thread (the agentlet's dump
    runs on its own thread, whose current CUDA device is the default)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclass(frozen=True)
class ServingConfig:
    batch_size: int = 1
    max_seq_len: int = 1024
    temperature: float = 0.0  # 0 → greedy
    seed: int = 0


class InferenceEngine:
    """Lock-step serving: every sequence of the batch at the same
    position. Owns params (frozen) and the migratable decode state."""

    def __init__(self, cfg: llama.LlamaConfig, params: dict,
                 scfg: ServingConfig | None = None,
                 device: torch.device | str | None = None) -> None:
        self.cfg = cfg
        self.scfg = scfg or ServingConfig()
        self.params = params
        self.device = resolve_device(device)
        self.state = self._fresh_state(self.device)
        # Host mirror of cache['length'], so the capacity guard reads no
        # state; resynced on restore.
        self._cache_len = 0

    def _fresh_state(self, device) -> dict:
        s = self.scfg
        return {
            "cache": llama.init_kv_cache(self.cfg, s.batch_size,
                                         s.max_seq_len, device=device),
            "last_token": torch.zeros((s.batch_size, 1), dtype=torch.int32,
                                      device=device),
            "rng": torch.tensor(stream_key(s.seed, 0), dtype=torch.uint32),
            "n_generated": torch.zeros((), dtype=torch.int32),
        }

    # -- generation -------------------------------------------------------------

    def _reserve(self, n: int) -> None:
        """Guard cache capacity on the host, before any write."""
        if self._cache_len + n > self.scfg.max_seq_len:
            raise ValueError(
                f"KV cache overflow: {self._cache_len} + {n} tokens exceeds "
                f"max_seq_len={self.scfg.max_seq_len}")
        self._cache_len += n

    def prefill(self, prompt) -> torch.Tensor:
        """Feed prompt (B, S); returns the first sampled token (B, 1)."""
        prompt = torch.as_tensor(prompt, dtype=torch.int32).to(self.device)
        self._reserve(prompt.shape[1])
        return self._step(prompt)

    def generate_step(self) -> torch.Tensor:
        """One autoregressive step from ``last_token``; returns (B, 1)."""
        self._reserve(1)
        return self._step(self.state["last_token"])

    def generate(self, n_tokens: int) -> torch.Tensor:
        """Emit ``n_tokens`` from the current state; (B, n)."""
        return torch.cat([self.generate_step() for _ in range(n_tokens)], 1)

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        """Decode and sample (the port of ``_decode_and_sample``)."""
        st = self.state
        logits, cache = llama.decode(self.cfg, self.params, tokens,
                                     st["cache"])
        last = logits[:, -1, :]
        t = self.scfg.temperature
        if t > 0.0:
            seed = sample_seed(st["rng"].tolist(), int(st["n_generated"]))
            last = last / t + _gumbel(last.shape, seed, last.device)
        tok = torch.argmax(last, dim=-1, keepdim=True).to(torch.int32)
        self.state = {"cache": cache, "last_token": tok, "rng": st["rng"],
                      "n_generated": st["n_generated"] + 1}
        return tok

    # -- migration --------------------------------------------------------------

    def snapshot(self, directory: str) -> str:
        """Dump the decode state (not params: those ship with the pod
        image, once, not per migration)."""
        quiesce(self.state)
        return write_snapshot(
            directory, self.state,
            meta={"n_generated": int(self.state["n_generated"])})

    def restore(self, directory: str) -> int:
        """Load the decode state; returns its ``n_generated``."""
        self.state = restore_snapshot(
            directory, like=self._fresh_state("meta"), device=self.device)
        self._cache_len = int(self.state["cache"]["length"])
        return int(self.state["n_generated"])


# -- continuous batching ------------------------------------------------------


@dataclass(frozen=True)
class BatchingConfig:
    """Continuous-batching engine knobs."""

    n_slots: int = 4
    max_seq_len: int = 1024
    temperature: float = 0.0  # 0 → greedy
    seed: int = 0
    eos_id: int | None = None
    # Prompts are padded up to the next bucket, so prefill runs one
    # shape per bucket, not per prompt length.
    prefill_buckets: tuple[int, ...] = (16, 64, 256, 1024)


class ContinuousBatchingEngine:
    """Continuous batching over a fixed slot grid.

    Each slot sits at its own cache position; sequences join mid-decode
    (:meth:`submit`), leave on EOS or the cache limit, and the freed slot
    is reused, all through one decode step of the grid's shape
    (:func:`~grit_tpu_torch.models.llama.decode_ragged`: raggedness is
    masking, never a shape). The whole decode state is one tree, so the
    snapshot migrates the batch mid-flight."""

    def __init__(self, cfg: llama.LlamaConfig, params: dict,
                 bcfg: BatchingConfig | None = None,
                 device: torch.device | str | None = None) -> None:
        self.cfg = cfg
        self.bcfg = bcfg or BatchingConfig()
        self.params = params
        self.device = resolve_device(device)
        self._submissions = 0  # the next admission's RNG stream (monotonic)
        self.state = self._fresh_state(self.device)

    def _fresh_state(self, device) -> dict:
        b = self.bcfg
        return {
            "cache": llama.init_kv_cache(self.cfg, b.n_slots, b.max_seq_len,
                                         device=device),
            "lengths": torch.zeros(b.n_slots, dtype=torch.int32),
            "active": torch.zeros(b.n_slots, dtype=torch.bool),
            "last_token": torch.zeros((b.n_slots, 1), dtype=torch.int32),
            "rngs": torch.tensor([stream_key(b.seed, i)
                                  for i in range(b.n_slots)],
                                 dtype=torch.uint32),
            "n_generated": torch.zeros(b.n_slots, dtype=torch.int32),
        }

    # -- admission -------------------------------------------------------------

    def free_slots(self) -> list[int]:
        return torch.nonzero(~self.state["active"]).flatten().tolist()

    def submit(self, prompt) -> int:
        """Admit a prompt into a free slot; returns the slot id. The next
        :meth:`step` decodes its first token alongside the running batch."""
        prompt = torch.as_tensor(prompt, dtype=torch.int32).cpu().reshape(-1)
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots — poll step()/release first")
        slot = free[0]
        n = prompt.numel()
        if n == 0:
            raise ValueError("empty prompt")
        # The bucket must also fit the cache.
        bucket = next((b for b in self.bcfg.prefill_buckets
                       if n <= b <= self.bcfg.max_seq_len), None)
        if bucket is None or n >= self.bcfg.max_seq_len:
            raise ValueError(
                f"prompt length {n} fits no prefill bucket within "
                f"max_seq_len={self.bcfg.max_seq_len}")
        padded = torch.zeros((1, bucket), dtype=torch.int32)
        padded[0, :n] = prompt
        st = self.state
        _cb_prefill(self.cfg, self.params, padded.to(self.device), slot,
                    st["cache"])
        # lengths = n-1 with the prompt's last token as last_token: the
        # next step() re-derives position n-1 (rewriting identical K/V)
        # and samples generated token 1, so every emitted token comes
        # from the one decode step; prefill never samples.
        st["lengths"][slot] = n - 1
        st["active"][slot] = True
        st["last_token"][slot, 0] = prompt[n - 1]
        st["rngs"][slot] = torch.tensor(
            stream_key(self.bcfg.seed, self.bcfg.n_slots + self._submissions),
            dtype=torch.uint32)
        st["n_generated"][slot] = 0
        self._submissions += 1
        return slot

    def release(self, slot: int) -> None:
        self.state["active"][slot] = False

    # -- decode ----------------------------------------------------------------

    def step(self) -> dict[int, int]:
        """One ragged decode for every active slot. Returns ``{slot:
        token}`` for the slots that emitted; slots hitting EOS or the
        cache limit deactivate (their final token is still reported)."""
        was_active = self.state["active"]  # the step rebinds, never mutates
        if not was_active.any():
            return {}
        self.state, toks = _cb_step(self.cfg, self.bcfg.temperature,
                                    self.bcfg.eos_id, self.params, self.state)
        out = toks.tolist()
        return {i: out[i] for i in torch.nonzero(was_active).flatten().tolist()}

    # -- migration -------------------------------------------------------------

    def snapshot_meta(self) -> dict:
        """Manifest metadata every dump of this engine carries (its own
        :meth:`snapshot` and the serving agentlet's dump)."""
        # submissions: the next admission's RNG stream id. Restoring it
        # keeps post-migration admissions off the streams that running
        # slots already use.
        return {"engine": "continuous-batching",
                "submissions": self._submissions}

    def snapshot_state(self) -> dict:
        """The state tree as it is dumped: KV pages that can never be
        attended (inactive slots' rows, positions past each slot's write
        waterline) zeroed, so a codec's zero-block elision ships a
        half-empty grid's cache as mostly empty payloads. Semantically
        the same state: those pages are prefilled or overwritten before
        any read."""
        st = self.state
        with _on(self.device):
            k, v = _tag_elidable_kv(st["cache"]["k"], st["cache"]["v"],
                                    st["lengths"], st["active"])
        return {**st, "cache": {**st["cache"], "k": k, "v": v}}

    def snapshot(self, directory: str, *, base: str | None = None) -> str:
        """Dump :meth:`snapshot_state`. ``base`` is accepted as the
        agentlet accepts it: the dump is full, which a delta reader takes
        as is."""
        del base
        quiesce(self.state)
        return write_snapshot(directory, self.snapshot_state(),
                              meta=self.snapshot_meta())

    def restore(self, directory: str) -> None:
        self.state = restore_snapshot(
            directory, like=self._fresh_state("meta"), device=self.device)
        self._submissions = int(
            SnapshotManifest.load(directory).meta.get("submissions", 0))


def _tag_elidable_kv(cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, active: torch.Tensor):
    """Copies of the caches with every page that can never be attended
    zeroed: inactive slots' whole rows, and positions past an active
    slot's write waterline (``pos <= lengths`` stays: the next step
    re-derives and rewrites position ``lengths`` itself)."""
    dev = cache_k.device
    lengths, active = lengths.to(dev), active.to(dev)
    pos = torch.arange(cache_k.shape[2], device=dev)
    live = active[None, :, None, None, None] & (
        pos[None, None, :, None, None] <= lengths[None, :, None, None, None])
    zero = torch.zeros((), dtype=cache_k.dtype, device=dev)
    return torch.where(live, cache_k, zero), torch.where(live, cache_v, zero)


def _cb_prefill(cfg: llama.LlamaConfig, params: dict, padded: torch.Tensor,
                slot: int, cache: dict) -> None:
    """Prefill one slot: run the (1, bucket) prompt through the decode
    trunk against the slot's cache rows, which it writes in place. Pad
    positions beyond the true prompt leave K/V that is never attended
    (the per-slot kv_len mask) and is overwritten as the slot generates
    into those positions. The logits are dropped: prefill never samples."""
    llama.decode(cfg, params, padded, {
        "k": cache["k"][:, slot:slot + 1],
        "v": cache["v"][:, slot:slot + 1],
        "length": torch.zeros((), dtype=torch.int32),
    })


def _cb_step(cfg: llama.LlamaConfig, temperature: float, eos_id: int | None,
             params: dict, state: dict) -> tuple[dict, torch.Tensor]:
    """The continuous-batching step: ragged decode, per-slot sample and
    slot bookkeeping for the whole grid. Returns (new state, tokens (B,)
    int32 on the host)."""
    active = state["active"]
    logits, cache = llama.decode_ragged(
        cfg, params, state["last_token"], state["cache"], state["lengths"],
        active)
    last = logits[:, -1, :]  # (B, vocab)
    if temperature > 0.0:
        noise = torch.zeros_like(last)
        for b in torch.nonzero(active).flatten().tolist():
            seed = sample_seed(state["rngs"][b].tolist(),
                               int(state["n_generated"][b]))
            noise[b] = _gumbel(last.shape[1:], seed, last.device)
        last = last / temperature + noise
    tok = torch.argmax(last, dim=-1).to(torch.int32).cpu()
    tok = torch.where(active, tok, state["last_token"][:, 0])
    new_lengths = state["lengths"] + active.to(torch.int32)
    still = active & (new_lengths < cache["k"].shape[2])
    if eos_id is not None:
        still = still & (tok != eos_id)
    return {
        "cache": cache,
        "lengths": new_lengths,
        "active": still,
        "last_token": tok[:, None],
        "rngs": state["rngs"],
        "n_generated": state["n_generated"] + active.to(torch.int32),
    }, tok
