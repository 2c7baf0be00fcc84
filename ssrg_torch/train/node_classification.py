"""Node classification (counterpart of ``ssrg_tpu/train/node_classification.py``).

``prepare`` normalizes the adjacency on the host, propagates K hops on the
device through the chosen SpMM engine and, when the message op is not
learnable, aggregates the hops once. The locality meta-engines
``reorder_banded`` and ``reorder_tiled`` renumber the graph first (RCM or
label-propagation clusters), propagate on the dense-block engine and put
the hops back in the original node order; ``autotune`` times the engines
and takes the fastest. The naive GCN keeps the normalized adjacency on the
device instead (``Prepared.adj_device``, differentiable through the ELL
kernel), the wavelet model the pair (Φ, Φ⁻¹) (``spectral``), and the
featureless ``clean_train`` model takes the raw features. A graph op that
gives a tuple of adjacencies propagates each: the magnetic ops as complex
numbers, whose last hop is the ``(re, im)`` input of the complex heads;
two_dir and two_order as separate stacks, whose last hops are concatenated.
The meta-engines fall back to ``auto`` (with a warning) on every path but
the hop precompute.

``NodeClassification`` trains with the reference's protocol: best-val
selects the reported test accuracy, ``normalize_times`` runs each
re-initialized from ``seed + i`` (mean over runs), full-batch or minibatch
training, batched evaluation, a checkpoint at every new best, resuming from
one, and the label-propagation postprocess. The reference's
``scan_epochs`` (all epochs in one ``lax.scan``) is accepted and runs the
same epoch loop.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ssrg_torch.cache import cached_propagate, load_metadata, load_params, save_params
from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.convert import params_from_jax, params_to_jax
from ssrg_torch.logger import span
from ssrg_torch.models.heads import BatchNorm
from ssrg_torch.models.zoo import (
    COMPLEX_GRAPH_OPS,
    GRAPH_OPS,
    MULTI_ADJACENCY_GRAPH_OPS,
    ModelSpec,
    PrecomputeModel,
)
from ssrg_torch.train.common import (
    TrainState,
    accuracy,
    batch_iterator,
    create_train_state,
    seed_everything,
    train_step,
)
from ssrg_torch.utils import DeviceLike, resolve_device, synchronize

log = logging.getLogger("ssrg_torch")


@dataclass
class Prepared:
    """Result of the precompute phase."""

    module: PrecomputeModel
    inputs: Any                 # [N, D], the hop stack [K+1, N, F] or (re, im)
    hops_layout: bool           # True when inputs is the hop stack
    adj_device: Any = None      # the naive GCN's device adjacency, or (Φ, Φ⁻¹)
    preprocess_seconds: float = 0.0  # the span ``prepare``
    # the basic engine name, with the meta-engines resolved ("auto" for
    # reorder_*): what a consumer that packs the adjacency again must use
    engine: str = "auto"


def _reorder_propagate(engine: str, spec: ModelSpec, adj_norm, x: np.ndarray,
                       model_cfg: ModelConfig, training_cfg: TrainingConfig,
                       dev: torch.device) -> torch.Tensor:
    """The locality meta-engines: renumber the nodes so that the adjacency
    is banded (RCM) or cluster-diagonal (label propagation), propagate on
    the dense-block engine, and take the hops back to the original order.
    A ``ValueError`` of the pack functions (not banded or clustered enough)
    or of the rest's slab guard falls back to the hybrid engine with a
    warning."""
    from ssrg_torch.ops.reorder import apply_permutation, reorder_permutation, reorder_plan

    method, dense_engine, merge_target, engine_kwargs = reorder_plan(
        engine, dev, training_cfg.spmm_bf16, training_cfg.cluster_merge_target)
    perm = reorder_permutation(adj_norm, method, merge_target=merge_target)
    adj_p, x_p, _, inverse = apply_permutation(adj_norm, perm, x)
    tag = (f"{spec.graph_op}:{model_cfg.r}:{method}"
           + (f":mt{merge_target}" if merge_target else "")
           + (":bf16" if training_cfg.spmm_bf16 else ""))
    try:
        hops_p = cached_propagate(adj_p, x_p, spec.prop_steps, training_cfg.cache_dir,
                                  dense_engine, tag=tag, device=dev,
                                  engine_kwargs=engine_kwargs)
    except ValueError as exc:
        log.warning("%s fell back to hybrid: %s", engine, exc)
        return cached_propagate(adj_norm, x, spec.prop_steps, training_cfg.cache_dir,
                                "hybrid", tag=f"{spec.graph_op}:{model_cfg.r}", device=dev)
    return hops_p.index_select(1, torch.as_tensor(inverse, device=dev))


def prepare(
    spec: ModelSpec,
    dataset,
    model_cfg: ModelConfig,
    training_cfg: TrainingConfig,
    device: DeviceLike = "cuda",
) -> Prepared:
    """Run the one-time precompute on ``device``: the span ``prepare``,
    around ``prepare.adjacency`` (the graph's first ``adj``),
    ``prepare.normalize``, the pack's spans, ``prepare.hops`` and
    ``prepare.message``; its duration is ``preprocess_seconds``."""
    if not isinstance(spec, ModelSpec):
        raise TypeError(
            f"expected a ModelSpec (from ssrg_torch.models.load_model), got "
            f"{type(spec).__name__}; did you pass the ModelConfig instead?"
        )
    with span("prepare") as whole:
        prepared = _prepare(spec, dataset, model_cfg, training_cfg, resolve_device(device))
    prepared.preprocess_seconds = whole.seconds
    return prepared


def _normalized(spec: ModelSpec, dataset, model_cfg: ModelConfig):
    adj = dataset.adj
    with span("prepare.normalize"):
        return spec.construct_adj(adj, model_cfg)


def _prepare(spec: ModelSpec, dataset, model_cfg: ModelConfig, training_cfg: TrainingConfig,
             dev: torch.device) -> Prepared:
    x = np.asarray(dataset.x)
    engine = training_cfg.spmm_engine
    if engine == "autotune":
        from ssrg_torch.ops.autotune import autotune_engine

        engine, _ = autotune_engine(dataset.adj, x.shape[1], device=dev)
    is_meta = engine in ("reorder_banded", "reorder_tiled")
    basic_engine = "auto" if is_meta else engine

    def warn_meta(path: str) -> None:
        # the reorder meta-engines apply to the hop precompute only
        if is_meta:
            log.warning(
                "spmm_engine=%s only applies to hop-precompute models; the %s path "
                "for model %r uses engine='auto' instead", engine, path, model_cfg.model_name,
            )

    def done(inputs, module=spec.module, hops_layout=False, adj_device=None) -> Prepared:
        synchronize(dev)
        return Prepared(module, inputs, hops_layout, adj_device=adj_device, engine=basic_engine)

    def raw_features(path: str, adj_device=None) -> Prepared:
        warn_meta(path)
        return done(torch.as_tensor(x, dtype=torch.float32, device=dev), adj_device=adj_device)

    if spec.spectral:
        from ssrg_torch.models.wavelet import prepare_spectral

        spec.module.head.set_num_nodes(dataset.num_node)
        phi, phi_inv = prepare_spectral(dataset.adj, model_cfg.wavelet, engine=basic_engine,
                                        device=dev)
        return raw_features("spectral", (phi, phi_inv))
    if spec.naive:
        from ssrg_torch.ops.sparse import differentiable_adjacency

        adj_norm = _normalized(spec, dataset, model_cfg)
        return raw_features("naive", differentiable_adjacency(adj_norm, basic_engine,
                                                              device=dev))
    if spec.graph_op is None:
        return raw_features("featureless")

    adj_norm = _normalized(spec, dataset, model_cfg)
    if isinstance(adj_norm, tuple):
        from ssrg_torch.ops.propagate import propagate_complex, propagate_multi
        from ssrg_torch.ops.sparse import device_adjacency

        warn_meta("tuple-adjacency")
        devs = tuple(device_adjacency(a, basic_engine, device=dev) for a in adj_norm)
        with span("prepare.hops"):
            if spec.graph_op in COMPLEX_GRAPH_OPS:
                re_hops, im_hops = propagate_complex(*devs, x, spec.prop_steps, device=dev)
                inputs = (re_hops[-1], im_hops[-1])
            else:
                stacks = propagate_multi(devs, x, spec.prop_steps, device=dev)
                inputs = torch.cat([h[-1] for h in stacks], dim=-1)
        return done(inputs)
    if is_meta:
        hops = _reorder_propagate(engine, spec, adj_norm, x, model_cfg, training_cfg, dev)
    else:
        hops = cached_propagate(
            adj_norm, x, spec.prop_steps, training_cfg.cache_dir, engine,
            tag=f"{spec.graph_op}:{model_cfg.r}", device=dev,
        )
    if spec.pre_msg_learnable:
        return done(hops, hops_layout=True)

    # aggregate now, once
    msg = spec.module.msg_op
    if msg is not None:
        with span("prepare.message"), torch.no_grad():
            aggregated = msg.to(dev)(hops)
        module = PrecomputeModel(msg_op=None, head=spec.module.head)
    else:
        aggregated, module = hops[-1], spec.module
    return done(aggregated, module=module)


def slice_inputs(prepared: Prepared, idx: torch.Tensor):
    """The rows of ``prepared.inputs`` for node ids ``idx``, for each
    layout: the complex ``(re, im)`` pair, the hop stack ``[K+1, N, F]``, or
    aggregated ``[N, D]``."""
    if isinstance(prepared.inputs, tuple):
        return tuple(part[idx] for part in prepared.inputs)
    if prepared.hops_layout:
        return prepared.inputs[:, idx]
    return prepared.inputs[idx]


def has_batch_norm(module: torch.nn.Module) -> bool:
    return any(isinstance(m, BatchNorm) for m in module.modules())


def load_checkpoint(module: torch.nn.Module, path: str,
                    require_stats: bool = True) -> Optional[dict]:
    """Restore a checkpoint of either package into ``module`` and return its
    metadata. A model with BatchNorm needs a checkpoint that holds its
    statistics (metadata ``has_bn``): a params-only one is refused with
    ``ValueError``, as the reference's ``Predictor`` does, or, with
    ``require_stats=False`` (the reference's ``resume_from``), restores the
    parameters and keeps the module's statistics."""
    meta = load_metadata(path)
    state = params_from_jax(load_params(path))
    if has_batch_norm(module) and not (meta or {}).get("has_bn"):
        if require_stats:
            raise ValueError(
                "model has BatchNorm but the checkpoint stores params only "
                "(pre-batch_stats format); retrain with checkpoint_path to produce a "
                "BN-aware checkpoint"
            )
        state = {**module.state_dict(), **state}
    module.load_state_dict(state, strict=True)
    return meta


def _checkpoint_payload(module: torch.nn.Module, has_bn: bool) -> dict:
    """The reference's checkpoint tree: ``{"params", "batch_stats"}`` for a
    model with BatchNorm, the bare params tree otherwise."""
    variables = params_to_jax(module.state_dict())
    return variables if has_bn else variables["params"]


class NodeClassification:
    """Train and evaluate with the reference's protocol: best-val selects
    the test accuracy, ``normalize_times`` runs give the mean (and, with
    ``verbose``, mean±std), an optional label-propagation postprocess.

    Runs on ``device`` (``cuda`` by default). After a run, ``state`` holds
    the :class:`~ssrg_torch.train.common.TrainState` and ``history`` the
    per-epoch ``loss``, ``val_acc`` and ``test_acc`` of the last run."""

    def __init__(
        self,
        dataset,
        spec: ModelSpec,
        model_cfg: ModelConfig,
        training_cfg: TrainingConfig,
        post_graph_op: Optional[str] = None,
        post_msg_aggr: str = "mean",
        verbose: bool = False,
        run: bool = True,
        device: DeviceLike = "cuda",
    ):
        if post_graph_op in MULTI_ADJACENCY_GRAPH_OPS:
            raise ValueError(f"post graph op {post_graph_op!r} gives a tuple of adjacencies; "
                             "label propagation needs one (sym, ppr or fast_ppr)")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.spec = spec
        self.model_cfg = model_cfg
        self.cfg = training_cfg
        self.post_graph_op = post_graph_op
        self.post_msg_aggr = post_msg_aggr
        self.verbose = verbose
        self.record = {"val_acc": [], "test_acc": []}
        self.history: dict = {}
        self.state: Optional[TrainState] = None

        self.labels = torch.as_tensor(np.asarray(dataset.y), dtype=torch.int64,
                                      device=self.device)
        self.train_idx = np.asarray(dataset.train_idx)
        self.val_idx = np.asarray(dataset.val_idx)
        self.test_idx = np.asarray(dataset.test_idx)
        # the splits' ids on the device once, so that no epoch copies them
        self._split = {name: self._idx(getattr(self, f"{name}_idx"))
                       for name in ("train", "val", "test")}

        self.prepared = prepare(spec, dataset, model_cfg, training_cfg, device=self.device)
        if run:
            for i in range(training_cfg.normalize_times):
                self.execute(seed=training_cfg.seed + i)
            if training_cfg.normalize_times > 1 and verbose:
                v, t = self.record["val_acc"], self.record["test_acc"]
                print(
                    f"Mean Val ± Std Val: {np.mean(v):.4f}±{np.std(v, ddof=1):.4f}, "
                    f"Mean Test ± Std Test: {np.mean(t):.4f}±{np.std(t, ddof=1):.4f}"
                )

    # -- public results ----------------------------------------------------

    @property
    def best_val(self) -> float:
        return float(np.mean(self.record["val_acc"]))

    @property
    def best_test(self) -> float:
        return float(np.mean(self.record["test_acc"]))

    def get_test_acc(self) -> float:
        return self.best_test

    # -- internals ---------------------------------------------------------

    def _idx(self, idx) -> torch.Tensor:
        if torch.is_tensor(idx):
            return idx
        return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=self.device)

    @property
    def full_graph(self) -> bool:
        return self.prepared.adj_device is not None

    @torch.no_grad()
    def logits(self, state: TrainState, idx=None) -> torch.Tensor:
        """Evaluation-mode logits of node ids ``idx`` (all nodes when None);
        a full-graph model (naive or spectral) runs on the whole graph and
        then selects."""
        p = self.prepared
        module = state.module.eval()
        with span("eval.forward"):
            if self.full_graph:
                out = module(p.inputs, p.adj_device)
                return out if idx is None else out[self._idx(idx)]
            ids = self._idx(np.arange(self.dataset.num_node) if idx is None else idx)
            return module(slice_inputs(p, ids))

    def _batched_accuracy(self, state: TrainState, idx: np.ndarray,
                          batch_size: int) -> torch.Tensor:
        """Memory-bounded evaluation: fixed-size batches with a padded tail
        whose rows weigh 0, summed on the device."""
        correct = torch.zeros((), device=self.device)
        total = torch.zeros((), device=self.device)
        rng = np.random.default_rng(0)
        for batch, w in batch_iterator(idx, batch_size, rng, shuffle=False):
            b = self._idx(batch)
            pred = self.logits(state, batch).argmax(dim=-1)
            wt = torch.as_tensor(w, device=self.device)
            correct += ((pred == self.labels[b]).float() * wt).sum()
            total += wt.sum()
        return correct / torch.clamp_min(total, 1.0)

    def evaluate(self, state: TrainState) -> Tuple[torch.Tensor, torch.Tensor]:
        """Validation and test accuracy, as device scalars: one full-graph
        forward for a naive or spectral model, batched when ``eval_batch_size`` is set,
        else one forward per split. The span ``epoch.evaluate``, each
        forward an ``eval.forward`` inside it."""
        bs = self.cfg.eval_batch_size
        splits = [self._split["val"], self._split["test"]]
        with span("epoch.evaluate"):
            if self.full_graph:
                logits = self.logits(state)
                return tuple(accuracy(logits[i], self.labels[i]) for i in splits)
            if bs is not None:
                return (self._batched_accuracy(state, self.val_idx, bs),
                        self._batched_accuracy(state, self.test_idx, bs))
            return tuple(accuracy(self.logits(state, i), self.labels[i]) for i in splits)

    def train_epoch(self, state: TrainState, np_rng: np.random.Generator) -> torch.Tensor:
        """One epoch: a full-batch step, or the reference's minibatches
        (shuffled by ``np_rng``, padded last batch weighing 0). Returns the
        mean loss on the device. The span ``epoch.train``."""
        p, cfg = self.prepared, self.cfg
        idx = self._split["train"]
        with span("epoch.train"):
            if self.full_graph:
                return train_step(state, p.inputs, self.labels[idx], idx=idx, adj=p.adj_device)
            if cfg.train_batch_size is None:
                return train_step(state, slice_inputs(p, idx), self.labels[idx])
            losses = []
            for batch, w in batch_iterator(self.train_idx, cfg.train_batch_size, np_rng):
                b = self._idx(batch)
                losses.append(train_step(state, slice_inputs(p, b), self.labels[b],
                                         torch.as_tensor(w, device=self.device)))
            return torch.stack(losses).mean()

    def _save(self, module, has_bn: bool, epoch: int, best_val: float, best_test: float) -> None:
        save_params(
            _checkpoint_payload(module, has_bn), self.cfg.checkpoint_path,
            metadata={"epoch": epoch, "val_acc": best_val, "test_acc": best_test,
                      "model": self.spec.name, "has_bn": has_bn},
        )

    def execute(self, seed: int = 2023) -> Tuple[float, float]:
        """One training run from a fresh initialization drawn with ``seed``."""
        p, cfg = self.prepared, self.cfg
        generator = seed_everything(seed, self.device)
        np_rng = np.random.default_rng(seed)
        # initialized on the host from a CPU generator: one seed, one
        # initialization, whatever the device
        module = p.module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(seed))
        module.to(self.device)
        if cfg.resume_from:
            load_checkpoint(module, cfg.resume_from, require_stats=False)
        state = create_train_state(module, generator, cfg.lr, cfg.weight_decay,
                                   cfg.warmup_epochs)
        best_val, best_test = self._run_epochs(state, np_rng, has_batch_norm(module))
        if self.verbose and cfg.normalize_times == 1:
            for epoch, (loss, av, at) in enumerate(zip(*self.history.values())):
                print(f"Epoch: {epoch + 1:03d}, loss_train: {loss:.4f}, "
                      f"acc_val: {av:.4f}, acc_test: {at:.4f}")
        if self.post_graph_op is not None:
            acc_val, acc_test = self._postprocess(state)
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test
        self.record["val_acc"].append(best_val)
        self.record["test_acc"].append(best_test)
        self.state = state
        return best_val, best_test

    def _run_epochs(self, state: TrainState, np_rng, has_bn: bool) -> Tuple[float, float]:
        """The reference's epoch loop: each epoch's accuracies come to the
        host, and a new best writes the checkpoint. ``scan_epochs`` runs it
        too: the epochs and the best they select are the same."""
        best_val = best_test = 0.0
        history = []
        for epoch in range(self.cfg.num_epochs):
            loss = self.train_epoch(state, np_rng)
            acc_val, acc_test = (float(a) for a in self.evaluate(state))
            history.append((loss, acc_val, acc_test))
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test
                if self.cfg.checkpoint_path:
                    self._save(state.module, has_bn, epoch + 1, best_val, best_test)
        losses = torch.stack([h[0] for h in history]).tolist() if history else []
        self.history = {"loss": losses, "val_acc": [h[1] for h in history],
                        "test_acc": [h[2] for h in history]}
        return best_val, best_test

    @torch.no_grad()
    def _postprocess(self, state: TrainState) -> Tuple[float, float]:
        """Label-propagation postprocess: propagate the softmax of every
        node's logits through the post graph op, combine the hops with
        ``post_msg_aggr`` and score again."""
        from ssrg_torch.ops.combine import make_message_op
        from ssrg_torch.ops.propagate import propagate
        from ssrg_torch.ops.sparse import device_adjacency

        probs = torch.softmax(self.logits(state), dim=1)
        post_adj = GRAPH_OPS[self.post_graph_op](self.dataset.adj, self.model_cfg)
        # prepared.engine is the resolved engine: the meta-engines are not
        # formats device_adjacency knows
        post_dev = device_adjacency(post_adj, self.prepared.engine, device=self.device)
        hops = propagate(post_dev, probs, self.spec.prop_steps, device=self.device)
        out = make_message_op(self.post_msg_aggr)(hops)
        val, test = self._idx(self.val_idx), self._idx(self.test_idx)
        return (float(accuracy(out[val], self.labels[val])),
                float(accuracy(out[test], self.labels[test])))
