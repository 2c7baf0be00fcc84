"""Out-of-core node classification (counterpart of
``ssrg_tpu/train/outofcore_task.py``): train a precompute model over the hop
directories that block-at-a-time propagation writes.

Neither the feature matrix nor any hop's feature matrix is ever held in
memory whole:

1. :func:`ssrg_torch.data.streaming.stream_partition` spools the
   sym-normalized adjacency into per-destination-block files in two disk
   passes (O(N) memory);
2. :func:`ssrg_torch.parallel.outofcore.outofcore_propagate` runs K hops
   block at a time on the device, writing ``hop<h>/block<i>.npy``;
3. :class:`OutOfCoreNodeClassification` trains any sym-norm precompute
   model (sgc/ssgc/sign/gbp/gamlp/nafs) on minibatches whose hop stack
   ``[K+1, B, F]`` is gathered from the hop directories
   (:func:`~ssrg_torch.parallel.outofcore.load_hop_rows`, memory-mapped),
   the next batch's gather running in a background thread.

The hop directories are the precompute's checkpoint: a rerun on the same
``work_dir`` skips both disk passes and the propagation, and a work
directory either package wrote is read by the other (the same file names
and formats).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.data.streaming import StreamingGraphMeta, stream_partition
from ssrg_torch.logger import get_logger
from ssrg_torch.models.zoo import ModelSpec, load_model
from ssrg_torch.parallel.outofcore import load_hop_rows, outofcore_propagate
from ssrg_torch.train.common import (
    batch_iterator,
    create_train_state,
    seed_everything,
    split_labels,
    train_step,
)
from ssrg_torch.utils import DeviceLike, resolve_device

META_FILE = "streaming_meta.json"


def save_meta(meta: StreamingGraphMeta, work_dir: str) -> str:
    path = osp.join(work_dir, META_FILE)
    with open(path, "w") as f:
        json.dump({"num_nodes": meta.num_nodes, "num_edges": meta.num_edges,
                   "block": meta.block, "num_shards": meta.num_shards,
                   "spool_dir": meta.spool_dir}, f)
    return path


def load_meta(work_dir: str) -> StreamingGraphMeta:
    with open(osp.join(work_dir, META_FILE)) as f:
        return StreamingGraphMeta(**json.load(f))


def ensure_spooled(edges_path: str, num_nodes: int, num_shards: int, work_dir: str,
                   r: float = 0.5) -> StreamingGraphMeta:
    """Spool the normalized adjacency unless ``work_dir`` already holds a
    spool of the same node and shard counts."""
    os.makedirs(work_dir, exist_ok=True)
    if osp.exists(osp.join(work_dir, META_FILE)):
        meta = load_meta(work_dir)
        if meta.num_nodes == num_nodes and meta.num_shards == num_shards:
            return meta
    meta = stream_partition(edges_path, num_nodes, num_shards, osp.join(work_dir, "spool"),
                            r=r)
    save_meta(meta, work_dir)
    return meta


def ensure_hops(meta: StreamingGraphMeta, features_path: str, prop_steps: int,
                work_dir: str, verbose: bool = False,
                device: DeviceLike = "cuda") -> List[str]:
    """Run out-of-core propagation on ``device`` unless every hop block
    already exists."""
    hop_dirs = [osp.join(work_dir, f"hop{h}") for h in range(prop_steps + 1)]
    if all(osp.exists(osp.join(d, f"block{i}.npy"))
           for d in hop_dirs for i in range(meta.num_shards)):
        return hop_dirs
    return outofcore_propagate(meta, features_path, prop_steps, work_dir, verbose=verbose,
                               device=device)


@dataclass
class OOCResult:
    best_val: float
    best_test: float
    hop_dirs: List[str]
    meta: StreamingGraphMeta
    history: dict = field(default_factory=dict)  # the trainer's ``history``


def _supported_spec(spec: ModelSpec, use_bn: bool) -> None:
    if spec.naive or spec.spectral or spec.graph_op != "sym":
        raise ValueError(
            f"out-of-core training supports sym-norm precompute models "
            f"(sgc/ssgc/sign/gbp/gamlp/nafs); got {spec.name!r} "
            f"(graph_op={spec.graph_op!r}, naive={spec.naive}, "
            f"spectral={spec.spectral})"
        )
    if spec.module.msg_op is None:
        raise ValueError(f"model {spec.name!r} has no hop-stack message op")
    if use_bn:
        raise ValueError("use_bn is not supported on the out-of-core path")


class OutOfCoreNodeClassification:
    """Minibatch best-val -> test trainer over on-disk hop directories, on
    ``device`` (``cuda`` by default).

    Every batch's hop stack ``[K+1, B, F]`` is gathered from disk and fed
    through the model's own message op and head, so the learnable
    aggregators (sign, gamlp) train per batch. Dropout draws from the run's
    ``torch.Generator``, which moves on with every draw: each batch gets
    draws of its own (``epoch0_batch_keys`` records the generator's state
    before each batch of the first epoch). After a run, ``history`` holds
    each epoch's mean loss, val accuracy and host-clock seconds (training
    and evaluation, which waits for the device)."""

    def __init__(
        self,
        meta: StreamingGraphMeta,
        hop_dirs: List[str],
        labels: np.ndarray,
        train_idx: np.ndarray,
        val_idx: np.ndarray,
        test_idx: np.ndarray,
        model_cfg: Optional[ModelConfig] = None,
        train_cfg: Optional[TrainingConfig] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.meta = meta
        self.hop_dirs = list(hop_dirs)
        self.labels = np.asarray(labels, np.int64)
        self.train_idx = np.asarray(train_idx, np.int64)
        self.val_idx = np.asarray(val_idx, np.int64)
        self.test_idx = np.asarray(test_idx, np.int64)
        self.mcfg = model_cfg or ModelConfig()
        self.tcfg = train_cfg or TrainingConfig()
        f_dim = int(np.load(osp.join(hop_dirs[0], "block0.npy"), mmap_mode="r").shape[1])
        self.num_classes = int(self.labels.max()) + 1
        if len(hop_dirs) != self.mcfg.prop_steps + 1:
            raise ValueError(f"hop_dirs has {len(hop_dirs)} entries but "
                             f"model prop_steps={self.mcfg.prop_steps}")
        self.spec = load_model(self.mcfg, f_dim, self.num_classes)
        _supported_spec(self.spec, self.mcfg.use_bn)
        self.feat_dim = f_dim
        self.labels_dev = torch.as_tensor(self.labels, device=self.device)
        self.history: dict = {}

    def _stack(self, idx: np.ndarray) -> np.ndarray:
        """One batch's hop stack ``[K+1, B, F]``, gathered from disk."""
        return np.stack([load_hop_rows(d, self.meta, idx) for d in self.hop_dirs], axis=0)

    def _prefetched(self, batches):
        """Yield ``(stack, batch_idx, weights)``, the next batch's disk
        gather running in a background thread while the device works on the
        current one."""
        batches = list(batches)
        if not batches:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._stack, batches[0][0])
            for cur, nxt in zip(batches, batches[1:]):
                nxt_fut = ex.submit(self._stack, nxt[0])
                yield fut.result(), cur[0], cur[1]
                fut = nxt_fut
            yield fut.result(), batches[-1][0], batches[-1][1]

    def _batch(self, stack: np.ndarray, b: np.ndarray, w: np.ndarray):
        dev = self.device
        return (torch.from_numpy(stack).to(dev), self.labels_dev[torch.as_tensor(b, device=dev)],
                torch.as_tensor(w, device=dev))

    @torch.no_grad()
    def _eval_split(self, module, idx: np.ndarray, batch: int, rng) -> float:
        module.eval()
        correct = torch.zeros((), device=self.device)
        for stack, b, w in self._prefetched(batch_iterator(idx, batch, rng, shuffle=False)):
            hops, labels, weights = self._batch(stack, b, w)
            correct += ((module(hops).argmax(dim=-1) == labels).float() * weights).sum()
        return float(correct) / max(idx.shape[0], 1)

    def execute(self, seed: Optional[int] = None) -> Tuple[float, float]:
        tcfg = self.tcfg
        seed = tcfg.seed if seed is None else seed
        generator = seed_everything(seed, self.device)
        nprng = np.random.default_rng(seed)
        batch = int(tcfg.train_batch_size or 512)
        # initialized on the host from a CPU generator: one seed, one
        # initialization, whatever the device
        module = self.spec.module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(seed))
        module.to(self.device)
        state = create_train_state(module, generator, tcfg.lr, tcfg.weight_decay,
                                   tcfg.warmup_epochs)

        best_val = best_test = 0.0
        log = get_logger()
        self.epoch0_batch_keys: List[bytes] = []
        losses, vals, seconds = [], [], []
        for epoch in range(tcfg.num_epochs):
            t0 = time.perf_counter()
            epoch_losses = []
            for stack, b, w in self._prefetched(batch_iterator(self.train_idx, batch, nprng)):
                if epoch == 0:
                    self.epoch0_batch_keys.append(bytes(generator.get_state().cpu().numpy()))
                hops, labels, weights = self._batch(stack, b, w)
                epoch_losses.append(train_step(state, hops, labels, weights))
            losses.append(torch.stack(epoch_losses).mean())
            val = self._eval_split(module, self.val_idx, batch, nprng)
            vals.append(val)
            if val >= best_val:
                best_val = val
                best_test = self._eval_split(module, self.test_idx, batch, nprng)
            seconds.append(time.perf_counter() - t0)
            if (epoch + 1) % 10 == 0:
                log.info("ooc epoch %d: val %.4f (best %.4f test %.4f)",
                         epoch + 1, val, best_val, best_test)
        self.history = {"loss": torch.stack(losses).tolist() if losses else [],
                        "val_acc": vals, "epoch_s": seconds}
        self.state = state
        return best_val, best_test


def run_outofcore(
    edges_path: str,
    features_path: str,
    labels_path: str,
    work_dir: str,
    num_shards: int = 8,
    model_cfg: Optional[ModelConfig] = None,
    train_cfg: Optional[TrainingConfig] = None,
    train_idx: Optional[np.ndarray] = None,
    val_idx: Optional[np.ndarray] = None,
    test_idx: Optional[np.ndarray] = None,
    verbose: bool = False,
    device: DeviceLike = "cuda",
) -> OOCResult:
    """End to end, on ``device``: spool, propagate, train.

    ``labels_path`` is an int64 ``.npy`` of shape [N]. Without splits, the
    class-balanced random protocol of ``split_labels`` picks them."""
    dev = resolve_device(device)
    mcfg = model_cfg or ModelConfig()
    tcfg = train_cfg or TrainingConfig()
    labels = np.load(labels_path)
    num_nodes = labels.shape[0]
    meta = ensure_spooled(edges_path, num_nodes, num_shards, work_dir, mcfg.r)
    hop_dirs = ensure_hops(meta, features_path, mcfg.prop_steps, work_dir, verbose=verbose,
                           device=dev)
    if train_idx is None:
        train_idx, val_idx, test_idx = split_labels(
            labels, num_val=max(num_nodes // 10, 10), num_test=max(num_nodes // 5, 10),
            seed=tcfg.seed)
    task = OutOfCoreNodeClassification(meta, hop_dirs, labels, train_idx, val_idx, test_idx,
                                       mcfg, tcfg, device=dev)
    best_val, best_test = task.execute()
    return OOCResult(best_val, best_test, hop_dirs, meta, task.history)
