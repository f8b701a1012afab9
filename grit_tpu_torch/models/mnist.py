"""The MNIST-scale MLP: the reference harness's own workload (BASELINE
configs 1 and 2), the smallest pod the pipeline migrates end to end.

Counterpart of ``grit_tpu/models/mnist.py``: the same parameter tree
(``w0``, ``b0``, ..., ``w_out``, ``b_out``, float32), forward, loss and
synthetic class-conditional batches. The batches are drawn from a
``torch.Generator`` (the Trainer seeds one by (seed, step)), not from a
threefry key: a stated divergence, as for the llama batches. The
deterministic stream is what makes resume exact, with no dataloader
state to dump.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MnistConfig:
    input_dim: int = 784
    hidden_dim: int = 256
    n_classes: int = 10
    n_hidden: int = 2


def _dims(cfg: MnistConfig) -> list[int]:
    return [cfg.input_dim] + [cfg.hidden_dim] * cfg.n_hidden


def init_params(cfg: MnistConfig, generator: torch.Generator | None,
                device: torch.device | str) -> dict:
    """Dense weights N(0, 1/fan_in), biases zeros, float32, on ``device``
    (``generator`` on the same device type; None with the meta device
    for the shape skeleton a restore loads into)."""
    dims = _dims(cfg)

    def weight(fan_in: int, fan_out: int) -> torch.Tensor:
        if torch.device(device).type == "meta":
            return torch.empty(fan_in, fan_out, device=device)
        w = torch.randn(fan_in, fan_out, generator=generator, device=device)
        return w / fan_in ** 0.5

    params: dict = {}
    for i in range(cfg.n_hidden):
        params[f"w{i}"] = weight(dims[i], dims[i + 1])
        params[f"b{i}"] = torch.zeros(dims[i + 1], device=device)
    params["w_out"] = weight(dims[-1], cfg.n_classes)
    params["b_out"] = torch.zeros(cfg.n_classes, device=device)
    return params


def forward(cfg: MnistConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    for i in range(cfg.n_hidden):
        x = torch.relu(x @ params[f"w{i}"] + params[f"b{i}"])
    return x @ params["w_out"] + params["b_out"]


def loss_fn(cfg: MnistConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean negative log-likelihood of ``batch["label"]``."""
    logp = torch.log_softmax(forward(cfg, params, batch["image"]), dim=-1)
    return -logp.gather(-1, batch["label"][:, None])[:, 0].mean()


def synthetic_batch(cfg: MnistConfig, generator: torch.Generator,
                    batch_size: int) -> dict:
    """Pseudo-MNIST on the CPU: each image is its label's one-hot tiled
    across the input plus N(0, 0.25) noise, so the loss genuinely falls
    and a diverged resume shows."""
    labels = torch.randint(0, cfg.n_classes, (batch_size,), generator=generator)
    centers = torch.nn.functional.one_hot(labels, cfg.n_classes).float()
    proto = centers.repeat(1, cfg.input_dim // cfg.n_classes + 1)[
        :, :cfg.input_dim]
    noise = torch.randn(batch_size, cfg.input_dim, generator=generator) * 0.5
    return {"image": proto + noise, "label": labels}
