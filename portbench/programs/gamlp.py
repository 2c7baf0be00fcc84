"""GAMLP as its users run it through the port: ``prepare`` (host
normalize, hybrid pack, copy, K hops), training full-batch under
``train/node_classification.py::NodeClassification`` (each epoch
``train_epoch`` then ``evaluate`` with the accuracies brought to the host),
and serving node ids through ``serve.py::Predictor.logits``."""

from __future__ import annotations

from typing import Dict

import torch

from portbench import work as W
from portbench.graphs import GraphData
from portbench.programs.common import (change_norms, dropout_generator,
                                       first_gradient_norms)


def _configs(cfg: dict):
    from ssrg_torch.configs.config import ModelConfig, TrainingConfig

    mc = ModelConfig(model_name="gamlp", num_layers=int(cfg["num_layers"]),
                     dropout=float(cfg["dropout"]), hidden_dim=int(cfg["hidden_dim"]),
                     prop_steps=int(cfg["prop_steps"]), r=float(cfg["r"]))
    tc = TrainingConfig(lr=float(cfg["lr"]), weight_decay=float(cfg["weight_decay"]),
                        spmm_engine=cfg["spmm_engine"], cache_dir=None)
    return mc, tc


def spec(cfg: dict):
    from ssrg_torch.models.zoo import load_model

    mc, _ = _configs(cfg)
    ds = cfg["dataset"]
    return load_model(mc, int(ds["num_features"]), int(ds["num_classes"]))


def weight_shapes(cfg: dict) -> list:
    """The state-dict names and shapes of the port's GAMLP: the ``jk`` hop
    scorer of ``ops/combine.py::LearnableWeightedMessageOp`` and the
    ``models/heads.py::MultiLayerPerceptron`` head."""
    ds = cfg["dataset"]
    f, c, h = int(ds["num_features"]), int(ds["num_classes"]), int(cfg["hidden_dim"])
    k = int(cfg["prop_steps"])
    out = [("msg_op.jk.weight", (1, (k + 2) * f), "weight"), ("msg_op.jk.bias", (1,), "bias")]
    fan_in = f
    for i in range(int(cfg["num_layers"]) - 1):
        out += [(f"head.fc_{i}.weight", (h, fan_in), "weight"),
                (f"head.fc_{i}.bias", (h,), "bias"),
                (f"head.prelu_{i}.slope", (), "slope")]
        fan_in = h
    out += [("head.fc_out.weight", (c, h), "weight"), ("head.fc_out.bias", (c,), "bias")]
    return out


def prepare(cfg: dict, dataset, model_spec, device):
    """One whole ``prepare``: it ends in a synchronize; its hop stack is
    ``.inputs``."""
    from ssrg_torch.train.node_classification import prepare as port_prepare

    mc, tc = _configs(cfg)
    return port_prepare(model_spec, dataset, mc, tc, device=device)


class TrainSession:
    """One ``NodeClassification`` (its ``prepare`` runs here, in set-up)
    and one train state over the benchmark's weights."""

    def __init__(self, data: GraphData, cfg: dict, weights: Dict[str, torch.Tensor],
                 seed: int, device, dataset=None):
        import numpy as np

        from ssrg_torch.train.common import create_train_state
        from ssrg_torch.train.node_classification import NodeClassification

        from portbench.programs.common import port_dataset

        mc, tc = _configs(cfg)
        self.task = NodeClassification(dataset or port_dataset(data), spec(cfg), mc, tc,
                                       run=False, device=device)
        module = self.task.prepared.module.to(device)
        module.load_state_dict(weights, strict=True)
        self.state = create_train_state(module, dropout_generator(seed, device), tc.lr,
                                        tc.weight_decay, tc.warmup_epochs)
        self.np_rng = np.random.default_rng(0)

    def step(self) -> torch.Tensor:
        loss = self.task.train_epoch(self.state, self.np_rng)
        self.accuracies = [float(a) for a in self.task.evaluate(self.state)]
        return loss

    def first_gradient_norms(self) -> Dict[str, float]:
        return first_gradient_norms(self.state)

    def change_norms(self, start) -> Dict[str, float]:
        return change_norms(self.state.module, start)

    def pack(self) -> dict:
        return {}

    def close(self) -> None:
        self.task = self.state = None


class Server:
    """A ``Predictor`` over the benchmark's weights (its ``prepare`` runs
    here, in set-up); a request is one ``logits`` call on numpy ids, its
    answer the logits on the host."""

    def __init__(self, data: GraphData, cfg: dict, weights, device, dataset=None):
        from ssrg_torch.serve import Predictor

        from portbench.programs.common import port_dataset

        mc, tc = _configs(cfg)
        self.predictor = Predictor(dataset or port_dataset(data), spec(cfg), mc, tc,
                                   params=weights, device=device)

    def request(self, ids) -> torch.Tensor:
        return self.predictor.logits(ids).cpu()

    def close(self) -> None:
        self.predictor = None


def _forward(w: W.Work, cfg: dict, rows: int, tag: str, train: bool) -> None:
    """The least work of GAMLP's forward on ``rows`` nodes: the hop rows
    gathered, the ``jk`` scores (a product over the concatenated hops),
    the weighted sum, the head."""
    ds = cfg["dataset"]
    f, c, h = int(ds["num_features"]), int(ds["num_classes"]), int(cfg["hidden_dim"])
    k = int(cfg["prop_steps"]) + 1
    W.elementwise(w, f"gather.{tag}", rows * k * f, 2)
    # each hop row is scored against all hops: the gathered rows read once
    w.add(f"jk.{tag}", 2.0 * k * rows * (k + 1) * f, W.F32 * k * rows * f)
    W.elementwise(w, f"combine.{tag}", rows * k * f, 1)
    fan_in = f
    for i in range(int(cfg["num_layers"]) - 1):
        W.gemm(w, f"fc{i}.{tag}", rows, fan_in, h)
        W.elementwise(w, f"prelu{'_dropout' if train else ''}{i}.{tag}", rows * h, 2)
        fan_in = h
    W.gemm(w, f"fc_out.{tag}", rows, h, c)


def epoch_work(cfg: dict, data: GraphData) -> W.Work:
    """The least work of one full-batch epoch: the training step (forward,
    backward, Adam) on the train rows, then the evaluation forwards on the
    validation and test rows."""
    ds = cfg["dataset"]
    f, c, h = int(ds["num_features"]), int(ds["num_classes"]), int(cfg["hidden_dim"])
    k = int(cfg["prop_steps"]) + 1
    n_tr = int(data.train_idx.numel())
    w = W.Work()
    _forward(w, cfg, n_tr, "train", True)
    W.elementwise(w, "loss", n_tr * c, 2)
    # backward: the head's products, the hop weights' gradient (the hops
    # read again), the scorer's weight gradient
    W.gemm(w, "fc_out.dW", h, n_tr, c)
    W.gemm(w, "fc_out.dX", n_tr, c, h)
    fan_in = [f] + [h] * (int(cfg["num_layers"]) - 2)
    for i in reversed(range(int(cfg["num_layers"]) - 1)):
        W.elementwise(w, f"prelu_dropout{i}.bwd", n_tr * h, 2)
        W.gemm(w, f"fc{i}.dW", fan_in[i], n_tr, h)
        W.gemm(w, f"fc{i}.dX", n_tr, h, fan_in[i])
    W.elementwise(w, "combine.bwd", n_tr * k * f, 1)
    w.add("jk.dW", 2.0 * k * n_tr * (k + 1) * f, W.F32 * k * n_tr * f)
    params = (k + 1) * f + 1 + sum((a + 1) * h + 1 for a in fan_in) + (h + 1) * c
    W.adam(w, params)
    for name, idx in (("val", data.val_idx), ("test", data.test_idx)):
        _forward(w, cfg, int(idx.numel()), name, False)
    return w
