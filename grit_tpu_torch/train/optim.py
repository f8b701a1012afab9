"""optax's gradient transformations as plain functions on tensors: the
port's optimizer seam.

Counterpart of the ``optax`` transforms the JAX package's ``Trainer``
takes (``grit_tpu/train/trainer.py``) and ``bench.py`` migrates:
:func:`adam`, :func:`sgd`, :func:`set_to_zero` and
:func:`multi_transform`. The state classes carry optax 0.2.6's names
and fields, so a state tree flattens to the same leaf names in both
packages and their snapshots cross-restore::

    adam(lr)                 (ScaleByAdamState(count, mu, nu), EmptyState())
    sgd(lr)                  (EmptyState(), EmptyState())
    set_to_zero()            EmptyState()
    multi_transform(...)     PartitionState(inner_states={label:
                                 MaskedState(inner_state=...)})

Inside a ``multi_transform``, each label's transform sees the parameter
tree with every other label's leaves replaced by a leafless
:class:`MaskedNode`, as optax's ``masked`` builds it; a frozen-trunk
state of ``sgd`` and ``set_to_zero`` therefore has no array leaf.

A transform's step is optax's ``update`` and ``apply_updates`` fused
into one in-place form, ``apply_(params, grads, state) -> state``: it
updates the parameters (and Adam's moments) in place, so the state has
one copy on the device. The arithmetic is optax's, in optax's order. Two
points where it follows the JAX ``Trainer``'s *jitted* step rather than
optax's eager ``apply_updates``:

- ``set_to_zero`` leaves its parameters untouched. XLA folds ``p + 0`` to
  ``p``, so a jitted step keeps a ``-0.0`` parameter ``-0.0``, where the
  eager ``p + 0.0`` gives ``+0.0``; a frozen leaf thus keeps its bytes,
  and a delta dump finds it clean.
- ``reads_grad(params)`` names the leaves whose transform reads its
  gradient. XLA drops the gradients a ``set_to_zero`` never reads; the
  Trainer asks autograd only for the others, so a frozen trunk runs no
  backward.

A sharded parameter (a DTensor, :mod:`grit_tpu_torch.parallel.sharding`)
is updated shard by shard: its gradient is first redistributed to the
parameter's placements, then the arithmetic runs on the local shards of
the parameter, the gradient and the moments (which ``init`` makes with
the parameter's placements). The update is elementwise, so each shard's
bytes are the dense update's at the same elements.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, Mapping, NamedTuple

import torch

from grit_tpu_torch.parallel.sharding import is_dtensor, local_shard
from grit_tpu_torch.tree import flatten_with_names, map_with_names, tree_map


class EmptyState(NamedTuple):
    """optax's leafless state (``identity``, ``scale``, ``set_to_zero``)."""


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: same fields, same snapshot names."""

    count: torch.Tensor
    mu: Any
    nu: Any


class MaskedNode(NamedTuple):
    """optax's placeholder for a leaf a ``masked`` transform does not own."""


class MaskedState(NamedTuple):
    """optax's ``MaskedState``."""

    inner_state: Any


class PartitionState(NamedTuple):
    """optax's ``PartitionState`` (the state of ``multi_transform``)."""

    inner_states: Any


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``apply_(params, grads, state) ->
    state``, optax's update applied to ``params`` in place;
    ``reads_grad(params) -> {leaf name: bool}``, whether the update reads
    that leaf's gradient (one that does not gets any tensor of the right
    shape)."""

    init: Callable[[Any], Any]
    apply_: Callable[[Any, Any, Any], Any]
    reads_grad: Callable[[Any], dict[str, bool]]


def _names(tree) -> list[str]:
    return [n for n, _ in flatten_with_names(tree)]


def _leaves(tree) -> list:
    return [x for _, x in flatten_with_names(tree)]


def _grad_for(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` of parameter ``p``, as ``p``'s local shard holds
    it. A DTensor gradient off ``p``'s placements (``Partial`` where ranks
    hold parts of its sum, as autograd returns the gradient of a
    parameter used as it is stored) is first redistributed to ``p``'s:
    the reduce-scatter over ``fsdp``, the all-reduce over ``data``."""
    if is_dtensor(g):
        if not is_dtensor(p):
            raise TypeError("a DTensor gradient for a plain parameter")
        g = g.redistribute(p.device_mesh, p.placements)
    return local_shard(g)


def _reads_every_grad(params) -> dict[str, bool]:
    return dict.fromkeys(_names(params), True)


# -- adam ------------------------------------------------------------------------


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return count + 1 if count < torch.iinfo(torch.int32).max else count


def _bias_corrections(count: torch.Tensor, b1: float,
                      b2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``1 - b ** count`` in fp32 (cast to each moment's dtype at use)."""
    t = count.float()
    return (1 - torch.tensor(b1, dtype=torch.float32) ** t,
            1 - torch.tensor(b2, dtype=torch.float32) ** t)


def _weak(x: float, t: torch.Tensor) -> float:
    """A Python scalar as JAX applies it to ``t``: rounded to ``t``'s dtype
    first (a weakly typed constant), where torch would compute with the
    unrounded value. Exact for f32; for bf16 it is the difference between
    ``0.9`` and ``0.8984375``."""
    return torch.tensor(x, dtype=t.dtype).item()


def _adam_leaf(g, mu, nu, bc1, bc2, *, b1, b2, eps, lr):
    """One leaf of ``scale_by_adam`` then ``scale_by_learning_rate``:
    ``(update, new mu before its cast to mu's dtype, new nu)``.

        mu = (1 - b1) g + b1 mu        nu = (1 - b2) g^2 + b2 nu
        mu_hat = mu / (1 - b1^t)       nu_hat = nu / (1 - b2^t)
        update = (-lr) mu_hat / (sqrt(nu_hat) + eps)
    """
    m = _weak(1 - b1, g) * g + _weak(b1, mu) * mu
    g2 = g * g
    v = _weak(1 - b2, g2) * g2 + _weak(b2, nu) * nu
    m_hat = m / bc1.to(m.dtype)
    root = torch.sqrt(v / bc2.to(v.dtype))
    u = m_hat / (root + _weak(eps, root))
    return u * _weak(-lr, u), m, v


def adam(learning_rate: float, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8,
         mu_dtype: torch.dtype | None = None) -> GradientTransformation:
    """optax ``adam``: ``chain(scale_by_adam, scale_by_learning_rate)``.
    ``mu`` is kept in ``mu_dtype`` (default: each parameter's dtype), ``nu``
    in the parameter's dtype, ``count`` an int32 scalar on the host (no
    device sync a step). The update uses ``mu`` before its cast, as
    optax's does."""
    kw = dict(b1=b1, b2=b2, eps=eps, lr=learning_rate)

    def init(params):
        return (ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype), params),
            nu=tree_map(torch.zeros_like, params)), EmptyState())

    @torch.no_grad()
    def apply_(params, grads, state):
        st = state[0]
        count = _safe_increment(st.count)
        bc1, bc2 = _bias_corrections(count, b1, b2)
        for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                                _leaves(st.mu), _leaves(st.nu)):
            g, p, mu, nu = _grad_for(g, p), local_shard(p), local_shard(mu), local_shard(nu)
            u, m, v = _adam_leaf(g, mu, nu, bc1, bc2, **kw)
            mu.copy_(m)
            nu.copy_(v)
            p.copy_((p + u).to(p.dtype))
        return (ScaleByAdamState(count=count, mu=st.mu, nu=st.nu),
                ) + tuple(state[1:])

    return GradientTransformation(init, apply_, _reads_every_grad)


# -- sgd and set_to_zero -----------------------------------------------------------


def sgd(learning_rate: float) -> GradientTransformation:
    """optax ``sgd`` without momentum: ``chain(identity(),
    scale_by_learning_rate)``; the update is ``(-lr) * g``."""
    step_size = -1 * learning_rate

    def init(params):
        del params
        return (EmptyState(), EmptyState())

    @torch.no_grad()
    def apply_(params, grads, state):
        for p, g in zip(_leaves(params), _leaves(grads)):
            g, p = _grad_for(g, p), local_shard(p)
            p.copy_((p + _weak(step_size, g) * g).to(p.dtype))
        return state

    return GradientTransformation(init, apply_, _reads_every_grad)


def set_to_zero() -> GradientTransformation:
    """optax ``set_to_zero``: zero updates. In place it writes nothing,
    and it reads no gradient (see the module docstring)."""

    def init(params):
        del params
        return EmptyState()

    def apply_(params, grads, state):
        del params, grads
        return state

    def reads_grad(params):
        return dict.fromkeys(_names(params), False)

    return GradientTransformation(init, apply_, reads_grad)


# -- multi_transform ---------------------------------------------------------------


def _mask(tree, keep: set[str]):
    return map_with_names(
        lambda name, x: x if name in keep else MaskedNode(), tree)


def multi_transform(transforms: Mapping[Hashable, GradientTransformation],
                    labels: Callable[[str], Hashable]) -> GradientTransformation:
    """optax ``multi_transform`` (``partition``): each parameter leaf is
    updated by ``transforms[labels(name)]``, ``name`` being the leaf's
    ``keystr`` name in the parameter tree (``"['lm_head']"``), as
    ``bench.py`` builds its labels from ``jax.tree_util.keystr``."""

    def groups(tree) -> dict[Hashable, set[str]]:
        out: dict[Hashable, set[str]] = {k: set() for k in transforms}
        for name in _names(tree):
            label = labels(name)
            if label not in transforms:
                raise ValueError(
                    f"parameter {name} has label {label!r}, which names no "
                    f"transform (transforms: {sorted(map(str, transforms))})")
            out[label].add(name)
        return out

    def init(params):
        owned = groups(params)
        return PartitionState({
            k: MaskedState(tx.init(_mask(params, owned[k])))
            for k, tx in transforms.items()})

    def apply_(params, grads, state):
        owned = groups(params)
        return PartitionState({
            k: MaskedState(tx.apply_(_mask(params, owned[k]),
                                     _mask(grads, owned[k]),
                                     state.inner_states[k].inner_state))
            for k, tx in transforms.items()})

    def reads_grad(params):
        owned = groups(params)
        out: dict[str, bool] = {}
        for k, tx in transforms.items():
            out.update(tx.reads_grad(_mask(params, owned[k])))
        return out

    return GradientTransformation(init, apply_, reads_grad)


# -- the migrated flagship's fine-tune ------------------------------------------------

TRAINABLE = ("['final_norm']", "['lm_head']")


def frozen_trunk_label(name: str) -> str:
    """``bench.py``'s labels: ``"train"`` for ``final_norm`` and
    ``lm_head``, ``"freeze"`` for every other leaf."""
    return "train" if name.startswith(TRAINABLE) else "freeze"


def frozen_trunk(learning_rate: float = 0.5) -> GradientTransformation:
    """The fine-tune ``bench.py`` migrates: ``sgd`` on the trainable slice,
    ``set_to_zero`` on the trunk."""
    return multi_transform({"train": sgd(learning_rate),
                            "freeze": set_to_zero()}, frozen_trunk_label)
