"""The port's entry points: :func:`entry` and :func:`dryrun_multichip`.

Counterparts of ``__graft_entry__.py``'s ``entry()`` (``:82``) and
``dryrun_multichip(n)`` (``:111``), which stay the JAX package's:

- :func:`entry` returns ``(fn, example_args)``: the llama forward at the
  reference's shapes (``LlamaConfig.tiny(dim=128, n_layers=4,
  max_seq_len=256)``, tokens (4, 128)) on the card. The reference falls
  back to the CPU when its chip's compile service wedges; here no GPU and
  no ``device="cpu"`` raises, as every entry point of the port does.
- :func:`dryrun_multichip` starts ``n`` ranks, one process each
  (:func:`~grit_tpu_torch.parallel.launch.run_ranks`), over
  :data:`~grit_tpu_torch.parallel.collectives.LOCAL_GLOO` sharing the
  card, or over gloo on ``n`` CPU processes with ``device="cpu"``; the
  reference provisions virtual devices in one process instead. The ranks
  run the reference's three phases at its shapes and bounds:

  (a) the tiny llama's sharded Trainer step on a (data, fsdp, model) mesh
      factored as the reference's (``:135-138``) against the dense step,
      within 1e-3 relative in bf16 and 1e-5 in its f32 twin;
  (b) the dp × pp × ep step of ``_dryrun_pipeline_moe`` (``:208-315``):
      a (data, pipe, expert) mesh factored as ``:228-234``, a stage
      ``x + moe(x)`` (dim 128, hidden 256, 8 experts, top-2), 4
      microbatches of ``2 * data`` rows split over ``data``, MSE against
      ``0.5 * x``, one SGD update of 0.05; the loss held to the same
      stages applied in sequence, unsharded, within 1e-6 relative;
  (c) the sequence-parallel llama forward through the ring and Ulysses
      over all ``n`` ranks (``n_heads = n_kv_heads = n``, f32) against
      the dense logits, within 1e-4.

  The parent prints the reference's one-line summary, the device's name
  in place of its ``platform``, and any miss raises.

Importing this module touches no device and imports nothing of JAX.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from grit_tpu_torch.device.placement import resolve_device
from grit_tpu_torch.models import llama, long_context
from grit_tpu_torch.ops.moe import init_moe_params, moe_mlp
from grit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    PIPE_AXIS,
    MeshSpec,
    build_mesh,
    build_pipe_mesh,
)
from grit_tpu_torch.parallel.collectives import reduce_sum
from grit_tpu_torch.parallel.pipeline import (
    microbatch,
    pipeline_apply,
    stack_stage_params,
)
from grit_tpu_torch.parallel.sharding import NamedSharding
from grit_tpu_torch.tree import flatten_with_names, tree_map

ENTRY_CFG = dict(dim=128, n_layers=4, max_seq_len=256)  # __graft_entry__.py:100
ENTRY_TOKENS = (4, 128)
DRYRUN_CFG = dict(dim=128, n_layers=4, n_heads=8, n_kv_heads=4)  # :142-143
STEP_BOUND = {"bf16": 1e-3, "f32": 1e-5}  # :171-192
PP_BOUND = 1e-6                           # :306-312
SP_BOUND = 1e-4                           # :349-354
# _dryrun_pipeline_moe's stage: dims, experts, microbatches, top-k, rate.
PP = dict(dim=128, hidden=256, n_experts=8, n_mb=4, top_k=2, lr=0.05)


def entry(device: torch.device | str | None = None
          ) -> tuple[Callable, tuple[dict, torch.Tensor]]:
    """``(fn, (params, tokens))``: the llama forward at the reference's
    shapes on ``device`` (default the card; with no GPU, pass
    ``"cpu"``). ``fn(params, tokens)`` → logits (4, 128, vocab) fp32."""
    dev = resolve_device(device)
    cfg = llama.LlamaConfig.tiny(**ENTRY_CFG)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, ENTRY_TOKENS,
                           generator=torch.Generator().manual_seed(1)).to(dev)

    def fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return llama.forward(cfg, params, tokens)

    return fn, (params, tokens)


def mesh_factors(n: int) -> tuple[int, int, int]:
    """(data, fsdp, model) of ``n`` ranks, as the reference factors them:
    the innermost axes take 2 when they can."""
    model = 2 if n % 2 == 0 else 1
    fsdp = 2 if (n // model) % 2 == 0 else 1
    return n // (model * fsdp), fsdp, model


def pipe_factors(n: int) -> tuple[int, int, int]:
    """(data, pipe, expert) of ``n`` ranks, as the reference's pp + ep
    phase factors them."""
    pipe = 2 if n % 2 == 0 else 1
    expert = 2 if (n // pipe) % 2 == 0 else 1
    return n // (pipe * expert), pipe, expert


# -- (a) the dp × fsdp × tp step -------------------------------------------------


def sharded_step(dev: torch.device) -> dict:
    """Phase (a) on this rank: one step of the tiny llama's Trainer on
    the factored (data, fsdp, model) mesh and one of a dense Trainer (the
    same seed, so the same weights and batch), in bf16 and in f32."""
    from grit_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: PLC0415

    shape = mesh_factors(dist.get_world_size())
    mesh = build_mesh(MeshSpec(*shape), dev)
    batch = shape[0] * shape[1]
    out: dict = {"mesh": dict(zip(mesh.mesh_dim_names, shape))}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cfg = llama.LlamaConfig.tiny(**DRYRUN_CFG, dtype=dtype)

        def batch_fn(gen, cfg=cfg):
            toks = torch.randint(0, cfg.vocab_size, (batch, 17), generator=gen)
            return toks[:, :-1], toks[:, 1:]

        def trainer(m, cfg=cfg, batch_fn=batch_fn):
            return Trainer(
                loss_fn=lambda p, b: llama.loss_fn(cfg, p, *b),
                init_params=lambda gen, d: llama.init_params(cfg, gen, d),
                batch_fn=batch_fn,
                cfg=TrainerConfig(learning_rate=1e-3,
                                  batch_spec=llama.BATCH_SPEC),
                device=dev, mesh=m,
                rules=None if m is None else llama.LLAMA_RULES)

        loss = float(trainer(mesh).train_step()["loss"])
        dense = float(trainer(None).train_step()["loss"])
        out[label] = {"loss": loss, "dense": dense, "err": abs(loss - dense)}
    return out


# -- (b) the dp × pp × ep step --------------------------------------------------


def pipeline_moe_inputs(data: int, pipe: int) -> tuple[dict, torch.Tensor]:
    """Phase (b)'s stacked stage parameters (router, w_in, w_out with a
    leading stage axis) and its ``n_mb * 2 * data`` input rows, from
    fixed seeds, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    stacked = stack_stage_params([
        init_moe_params(gen, PP["dim"], PP["hidden"], PP["n_experts"])
        for _ in range(pipe)])
    x = torch.randn(PP["n_mb"] * 2 * data, PP["dim"],
                    generator=torch.Generator().manual_seed(1))
    return stacked, x


def moe_stage_shardings(mesh) -> dict:
    """The reference's layout of the stacked stage parameters: the router
    over ``pipe``, the experts' weights over ``pipe`` and ``expert``."""
    return {"router": NamedSharding(mesh, (PIPE_AXIS,)),
            "w_in": NamedSharding(mesh, (PIPE_AXIS, EXPERT_AXIS)),
            "w_out": NamedSharding(mesh, (PIPE_AXIS, EXPERT_AXIS))}


def _moe_stage(mesh=None) -> Callable:
    """The reference's stage: a top-2 MoE over the microbatch's rows with
    the residual around it; ``mesh``: expert-parallel over ``expert``,
    the routing global over the rows of the mesh's other axes."""
    def stage(params: dict, x: torch.Tensor) -> torch.Tensor:
        y, _aux = moe_mlp(params, x, top_k=PP["top_k"], mesh=mesh)
        return x + y

    return stage


def row_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Each row's mean squared error (the reference's ``mse`` over a
    microbatch is these rows' mean)."""
    return ((pred - target) ** 2).mean(dim=-1)


def global_row_mean(out_mb: torch.Tensor, y_mb: torch.Tensor,
                    data_group) -> torch.Tensor:
    """The mean over the microbatches of each one's mean row MSE, from
    this rank's rows of each (dim 1 split over ``data_group``): each
    shard's sum, summed over the group (:func:`reduce_sum`, whose
    backward hands every shard the cotangent), over the global row
    count. A mean of the shards' means would weigh a shard by its share
    of the ranks, not of the rows.

    Only the loss is summed over ``data_group``: a rank's gradient of a
    parameter it holds whole is its own rows' part. A stage must sum
    those parts itself, as the expert layer's token groups do in
    :func:`pipeline_moe_loss`."""
    per = []
    for o, y in zip(out_mb, y_mb):
        rows = row_mse(o, y)
        count = rows.new_tensor(float(rows.numel()))
        per.append(reduce_sum(rows.sum(), data_group)
                   / reduce_sum(count, data_group))
    return torch.stack(per).mean()


def pipeline_moe_loss(mesh, local: dict, x_mb: torch.Tensor,
                      y_mb: torch.Tensor) -> torch.Tensor:
    """Phase (b)'s loss on this rank of the (data, pipe, expert) mesh:
    the reference's ``pipeline_loss`` of the MoE stage over ``pipe``,
    with this rank's rows of each microbatch (``x_mb``, ``y_mb``: dim 1
    split over ``data``) and its shard of the stacked stage parameters
    (``local``). The same value on every rank, and each rank's gradient
    is its shard of the whole one: the stage's expert layer runs on the
    (data, expert) sub-mesh, whose replication of the router and the
    experts over those token groups sums every data shard's part in the
    backward (:func:`global_row_mean` sums only the loss)."""
    out = pipeline_apply(_moe_stage(mesh[DATA_AXIS, EXPERT_AXIS]), local,
                         x_mb, axis=mesh.get_group(PIPE_AXIS))
    return global_row_mean(out, y_mb, mesh.get_group(DATA_AXIS))


def dense_pipeline_loss(stacked: dict, x_mb: torch.Tensor,
                        y_mb: torch.Tensor) -> torch.Tensor:
    """The same stages applied in sequence, unsharded, to each whole
    microbatch; the mean over the microbatches of each one's mean row
    loss."""
    n_stages = flatten_with_names(stacked)[0][1].shape[0]
    stages = [tree_map(lambda a, i=i: a[i], stacked) for i in range(n_stages)]
    stage = _moe_stage()
    per = []
    for i in range(x_mb.shape[0]):
        h = x_mb[i]
        for p in stages:
            h = stage(p, h)
        per.append(row_mse(h, y_mb[i]).mean())
    return torch.stack(per).mean()


def data_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of microbatches ``t`` (M, mb, ...): dim 1 split
    over ``data``, in rank order (the reference's ``P(None, "data")``)."""
    d = mesh.get_coordinate()[mesh.mesh_dim_names.index(DATA_AXIS)]
    return t.chunk(mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)), dim=1)[d]


def pipeline_moe_step(dev: torch.device, stacked: dict | None = None,
                      x: torch.Tensor | None = None) -> dict:
    """Phase (b) on this rank: the dp × pp × ep step of the reference's
    ``_dryrun_pipeline_moe`` on the factored (data, pipe, expert) mesh.
    ``stacked`` and ``x`` default to :func:`pipeline_moe_inputs`'
    (``x`` has ``n_mb * 2 * data`` rows). Returns the loss, the dense
    composition's, this rank's shard of each gradient and of the updated
    parameters, and its mesh coordinate."""
    data, pipe, expert = pipe_factors(dist.get_world_size())
    mesh = build_pipe_mesh(dev, data=data, expert=expert)
    if stacked is None:
        stacked, x = pipeline_moe_inputs(data, pipe)
    stacked = tree_map(lambda a: a.to(dev), stacked)
    x = x.to(dev)
    shardings = moe_stage_shardings(mesh)
    local = {k: shardings[k].distribute(v).requires_grad_(True)
             for k, v in stacked.items()}
    x_mb = microbatch(x, PP["n_mb"])
    y_mb = microbatch(0.5 * x, PP["n_mb"])
    loss = pipeline_moe_loss(mesh, local, data_rows(mesh, x_mb),
                             data_rows(mesh, y_mb))
    names = list(local)
    grads = dict(zip(names, torch.autograd.grad(loss, [local[k]
                                                       for k in names])))
    with torch.no_grad():
        dense = dense_pipeline_loss(stacked, x_mb, y_mb)
    return {"mesh": {"names": list(mesh.mesh_dim_names),
                     "shape": list(mesh.shape),
                     "coord": list(mesh.get_coordinate())},
            "loss": float(loss.detach()), "dense": float(dense),
            "err": abs(float(loss.detach()) - float(dense)),
            "grads": {k: g.detach() for k, g in grads.items()},
            "updated": {k: (local[k] - PP["lr"] * grads[k]).detach()
                        for k in names}}


# -- (c) sequence parallelism ----------------------------------------------------


def seq_parallel(dev: torch.device, params: dict | None = None,
                 tokens: torch.Tensor | None = None) -> dict:
    """Phase (c) on this rank: its shard of the logits of ``forward_sp``
    through the ring and through Ulysses over every rank, and the largest
    error of any rank against the dense forward."""
    n, r = dist.get_world_size(), dist.get_rank()
    # n heads and n kv heads: Ulysses splits the heads over the ranks.
    cfg = llama.LlamaConfig.tiny(max_seq_len=max(16 * n, 128), n_heads=n,
                                 n_kv_heads=n, dtype=torch.float32)
    if params is None:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(2), dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, 16 * n),
                               generator=torch.Generator().manual_seed(3))
    params = tree_map(lambda a: a.to(dev), params)
    tokens = tokens.to(dev)
    s = tokens.shape[1] // n
    with torch.no_grad():
        dense = llama.forward(cfg, params, tokens)[:, r * s:(r + 1) * s]
        out: dict = {"logits": {}, "err": {}}
        for impl in ("ring", "ulysses"):
            got = long_context.forward_sp(
                cfg, params, tokens[:, r * s:(r + 1) * s], attn_impl=impl)
            err = (got - dense).abs().max().reshape(1)
            dist.all_reduce(err, op=dist.ReduceOp.MAX)
            out["logits"][impl] = got
            out["err"][impl] = float(err)
    return out


# -- the launch ------------------------------------------------------------------


def dryrun_phases(dev: torch.device) -> dict:
    """Phases (a)–(c) on this rank; the numbers each phase's bound
    holds (the same on every rank)."""
    a = sharded_step(dev)
    b = pipeline_moe_step(dev)
    c = seq_parallel(dev)
    return {"step": a,
            "pp": {k: b[k] for k in ("mesh", "loss", "dense", "err")},
            "sp": c["err"]}


def dryrun_misses(res: dict) -> list[str]:
    """Every bound of :func:`dryrun_phases`' numbers that does not hold."""
    misses = []
    for label, bound in STEP_BOUND.items():
        got = res["step"][label]
        if not (got["loss"] == got["loss"]
                and got["err"] < bound * max(1.0, abs(got["dense"]))):
            misses.append(f"dp×fsdp×tp {label} step diverged from dense: "
                          f"{got['loss']} vs {got['dense']} (bound {bound})")
    pp = res["pp"]
    if not pp["err"] < PP_BOUND * max(1.0, abs(pp["dense"])):
        misses.append(f"pp+ep diverged from dense: {pp['loss']} vs "
                      f"{pp['dense']} (err {pp['err']:.2e})")
    for impl, err in res["sp"].items():
        if not err < SP_BOUND:
            misses.append(f"seq-parallel ({impl}) diverged from dense: max "
                          f"logit err {err:.2e}")
    return misses


def dryrun_summary(res: dict, n: int, device_name: str) -> str:
    """The reference's one-line summary of :func:`dryrun_phases`'
    numbers, the device's name in place of its platform."""
    a = res["step"]
    return (f"dryrun_multichip OK: mesh={a['mesh']} devices={n} "
            f"device={device_name} step_loss={a['bf16']['loss']:.4f} (vs "
            f"dense err={a['bf16']['err']:.2e} bf16; f32 twin "
            f"err={a['f32']['err']:.2e}) pp+ep_step_loss="
            f"{res['pp']['loss']:.4f} (vs dense err={res['pp']['err']:.2e}) "
            f"sp_max_err={max(res['sp'].values()):.2e} "
            f"axes=dp,fsdp,tp,pp,ep,sp")


def dryrun_rank(device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip` (``run_ranks`` starts it)."""
    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    return dryrun_phases(dev)


def dryrun_multichip(n_devices: int,
                     device: torch.device | str | None = None) -> dict:
    """Run phases (a)–(c) on ``n_devices`` ranks sharing the card (over
    ``LOCAL_GLOO``), or on ``n_devices`` CPU processes over gloo with
    ``device="cpu"``; print the summary line and return rank 0's numbers.
    Raises on any miss, and with no GPU unless the CPU is asked for."""
    from grit_tpu_torch.parallel.collectives import LOCAL_GLOO  # noqa: PLC0415
    from grit_tpu_torch.parallel.launch import run_ranks  # noqa: PLC0415

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from grit_tpu_torch.ops import build  # noqa: PLC0415

        build.build_all()  # the ranks load the libraries, never race to build
    ranks = run_ranks(dryrun_rank, n_devices, dev.type,
                      backend=LOCAL_GLOO if on_card else "gloo",
                      timeout=1200)
    res = ranks[0]
    misses = dryrun_misses(res)
    if misses:
        raise AssertionError("; ".join(misses))
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(dryrun_summary(res, n_devices, name), flush=True)
    return res

