"""The system under test: ``repro_torch``'s LM train step, built from a
configuration file and driven the way ``repro_torch.launch.train.train``
drives it.

This is the one module of the benchmark that imports the program.  It maps
the configuration file to the port's ``ModelConfig`` (the published keys,
and the port's own settings under ``run``), builds the train state around
parameters the benchmark made (``launch.steps``' layout: ``params``,
AdamW's fp32 moments under ``opt``, ``step``; held equal to
``train_state_spec`` leaf by leaf), and runs ``build_train_step``'s step on
a batch.  It also hands out what the correctness check reads of the
program's state: the parameters and AdamW's first moments.
"""

from __future__ import annotations

from typing import Iterator

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import (
    TrainSettings,
    build_train_step,
    train_state_spec,
)
from repro_torch.models.api import get_model
from repro_torch.optim import adamw

__all__ = ["model_config", "TrainProgram"]

# the program's AdamW constants (``optim.adamw``'s defaults, which
# ``launch.steps`` does not set): the traffic file must state these
ADAM = {"adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8}


def model_config(cfg: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file.  Raises where
    the file asks for what the port cannot run: a Granite multiplier other
    than the neutral one, another activation, biases in the MLP."""
    hd = cfg["head_dim"]
    neutral = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
               "logits_scaling": 1.0, "attention_multiplier": hd ** -0.5}
    for key, value in neutral.items():
        if abs(cfg[key] - value) > 1e-12 * value:
            raise ValueError(f"{cfg['name']}: the port runs {key} = {value} "
                             f"only, the file asks {cfg[key]}")
    if cfg["hidden_act"] != "silu" or cfg.get("mlp_bias", False):
        raise ValueError(f"{cfg['name']}: the port runs a bias-free SwiGLU")
    run = cfg["run"]
    experts = cfg.get("num_local_experts", 0)
    kw = dict(
        name=cfg["name"], family="moe" if experts else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=hd,
        d_ff=0 if experts else cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], qkv_bias=cfg["attention_bias"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        dtype=run["compute_dtype"], param_dtype=run["param_dtype"],
        remat=run["remat"] != "none",
        remat_policy=run["remat"] if run["remat"] != "none" else "full",
        vocab_pad_multiple=run["vocab_pad_multiple"])
    if experts:
        if run["router_dtype"] != "float32":
            raise ValueError("the port keeps the router in float32")
        kw.update(n_experts=experts,
                  experts_per_token=cfg["num_experts_per_tok"],
                  moe_d_ff=cfg["intermediate_size"],
                  router_aux_coef=cfg["router_aux_loss_coef"],
                  capacity_factor=run["moe_capacity_factor"],
                  moe_group_size=run["moe_group_size"])
    return ModelConfig(**kw)


def _flat(tree, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flat(val, path + "/")
        else:
            yield path, val


def _nest(leaves: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in leaves.items():
        *head, last = path.split("/")
        node = tree
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


class TrainProgram:
    """The port's train step of one configuration under one traffic file,
    with its state."""

    def __init__(self, cfg: dict, train: dict):
        for key, value in ADAM.items():
            if train[key] != value:
                raise ValueError(f"the program's AdamW has {key} = {value}, "
                                 f"the traffic file {train[key]}")
        self.model = get_model(model_config(cfg))
        self.settings = TrainSettings(
            learning_rate=train["learning_rate"],
            weight_decay=train["weight_decay"],
            grad_clip=train["grad_clip"],
            microbatches=train["microbatches"])
        self.step_fn = build_train_step(self.model, self.settings)
        self.state: dict | None = None

    def start(self, params: dict[str, torch.Tensor]) -> None:
        """The train state around ``params`` (stacked leaves by path), with
        zero moments and step 0: ``launch.steps``' layout, checked against
        ``train_state_spec`` leaf by leaf."""
        tree = _nest(params)
        device = next(iter(params.values())).device
        state = {"params": tree,
                 "opt": adamw(self.settings.learning_rate,
                              weight_decay=self.settings.weight_decay
                              ).init(tree),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        want = dict(_flat(train_state_spec(self.model, self.settings)))
        have = dict(_flat(state))
        if want.keys() != have.keys():
            raise ValueError(f"state leaves differ from the program's: "
                             f"{sorted(want.keys() ^ have.keys())}")
        for path, t in have.items():
            if (t.shape, t.dtype) != (want[path].shape, want[path].dtype):
                raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, the "
                                 f"program's {tuple(want[path].shape)} "
                                 f"{want[path].dtype}")
        self.state = state

    def step(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One train step on ``batch`` (tokens, labels): the loss and the
        global gradient norm, 0-d tensors on the device."""
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss"], metrics["grad_norm"]

    def params(self) -> dict[str, torch.Tensor]:
        return dict(_flat(self.state["params"]))

    def first_moments(self) -> dict[str, torch.Tensor]:
        """AdamW's first moment of each leaf (fp32): after the first step,
        that step's gradient as AdamW took it times 1 - b1."""
        return dict(_flat(self.state["opt"]["m"]))

    def free(self) -> None:
        self.state = None
