"""The ``ssrg-torch`` command line (counterpart of ``ssrg_tpu/cli.py``).

One subcommand per pipeline, each filling the dataclass configs from its
flags and calling the port's entry point. The flags, their defaults and the
printed lines are the reference CLI's, so a script that reads ``Best val:
..., best test: ...`` or the bench's JSON line reads both. Every subcommand
but ``sparsify`` takes ``--device`` (``cuda`` by default; without a card it
raises, and ``--device cpu`` runs on the host).

Subcommands:
- ``train``     node classification on a dataset
- ``spmd``      SPMD training over a (graph, data) mesh of ranks
- ``sparsify``  graph sparsification pipeline
- ``augment``   robust augmentation pipeline
- ``baseline``  message-passing baseline zoo
- ``link``      link classification
- ``gwnn``      standalone GWNN pipeline
- ``predict``   checkpoint-backed inference (``ssrg_torch/serve.py``)
- ``autotune``  per-graph SpMM engine diagnosis
- ``ooc``       out-of-core spool -> propagate -> train
- ``bench``     K-hop SpMM precompute benchmark
"""

from __future__ import annotations

import argparse
import contextlib
import sys


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_name", default="sgc",
                   help="sgc|ssgc|sign|gbp|gamlp|nafs|gcn|wavelet|clean_train"
                        "|magnet|two_dir|two_order")
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--prop_steps", type=int, default=3)
    p.add_argument("--r", type=float, default=0.5)
    p.add_argument("--ppr_alpha", type=float, default=0.1)
    p.add_argument("--message_alpha", type=float, default=0.5)
    p.add_argument("--q", type=float, default=0.05)
    p.add_argument("--edge_mode", default="concat",
                   help="link-scorer pair features: concat|hadamard")


def _add_training_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--normalize_times", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--warmup_epochs", type=int, default=0,
                   help="linear lr ramp over the first N epochs (reference "
                        "adjust_learning_rate)")
    p.add_argument("--train_batch_size", type=int, default=None)
    p.add_argument("--eval_batch_size", type=int, default=None)
    p.add_argument("--spmm_engine", default="auto",
                   help="auto|dense|coo|ell|hybrid|banded|tiled|reorder_banded|reorder_tiled|pallas|pallas_banded|autotune")
    p.add_argument("--spmm_bf16", action="store_true",
                   help="bf16 dense-block storage for the reorder engines "
                        "(rounds the precompute to half precision)")
    p.add_argument("--cluster_merge_target", type=int, default=0,
                   help="reorder_tiled only: merge LPA communities into "
                        "super-clusters of up to N nodes (heavy-edge "
                        "matching) before the tiled pack — raises the "
                        "dense-tile fraction on fragmented community "
                        "structure (0 = flat LPA)")
    p.add_argument("--scan_epochs", action="store_true",
                   help="accepted; the epochs run in the same host loop "
                        "(full-batch, BN-free runs)")
    p.add_argument("--checkpoint_path", default=None,
                   help="save best-val params here (ssrg-torch predict reads it)")
    p.add_argument("--resume_from", default=None,
                   help="warm-start params from a checkpoint")
    p.add_argument("--cache_dir", default=None,
                   help="disk cache for propagated hop features")


def _add_data_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_name", default="cora_0_0")
    p.add_argument("--data_root", default="./sparsity_datasets/simhomo/Planetoid")
    p.add_argument("--data_split", default="official")
    p.add_argument("--surrogate_features", action="store_true",
                   help="ignore feature.pt and build deterministic "
                        "structural features from the intact edge list "
                        "(for snapshots with truncated feature blobs)")
    p.add_argument("--synthetic", action="store_true",
                   help="use a hermetic SBM dataset instead of files")
    p.add_argument("--synthetic_nodes", type=int, default=2708)
    p.add_argument("--synthetic_classes", type=int, default=7)
    p.add_argument("--synthetic_features", type=int, default=256)


def _load_dataset(args):
    if args.synthetic:
        from ssrg_torch.data.synthetic import planetoid_like

        return planetoid_like(
            num_node=args.synthetic_nodes,
            num_classes=args.synthetic_classes,
            num_features=args.synthetic_features,
            seed=args.seed,
        )
    from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset

    return load_homo_simplex_sparsity_dataset(
        name=args.data_name, root=args.data_root, split=args.data_split,
        surrogate_features=getattr(args, "surrogate_features", False),
    )


def _model_config(args, **extra):
    from ssrg_torch.configs.config import ModelConfig

    return ModelConfig(
        model_name=args.model_name, num_layers=args.num_layers,
        dropout=args.dropout, hidden_dim=args.hidden_dim,
        prop_steps=args.prop_steps, r=args.r, ppr_alpha=args.ppr_alpha,
        message_alpha=args.message_alpha, q=args.q, **extra,
    )


def cmd_train(args) -> int:
    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.train.node_classification import NodeClassification

    dataset = _load_dataset(args)
    model_cfg = _model_config(args, edge_mode=args.edge_mode)
    train_cfg = TrainingConfig(
        seed=args.seed, normalize_times=args.normalize_times,
        num_epochs=args.num_epochs, lr=args.lr,
        weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs,
        train_batch_size=args.train_batch_size,
        eval_batch_size=args.eval_batch_size,
        spmm_engine=args.spmm_engine,
        spmm_bf16=args.spmm_bf16,
        cluster_merge_target=args.cluster_merge_target,
        scan_epochs=args.scan_epochs,
        checkpoint_path=args.checkpoint_path,
        resume_from=args.resume_from,
        cache_dir=args.cache_dir,
    )
    spec = load_model(model_cfg, dataset.num_features, dataset.num_classes)
    task = NodeClassification(
        dataset, spec, model_cfg, train_cfg, verbose=args.verbose, device=args.device
    )
    print(f"Best val: {task.best_val:.4f}, best test: {task.best_test:.4f}")
    return 0


def _end_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def cmd_spmd(args) -> int:
    """SPMD training over a (graph, data) mesh of ranks.

    The world is ``torchrun``'s (joined by ``initialize_multihost``), or a
    world of one rank that ``make_mesh`` starts; a world this command
    started ends with it. The mesh spans the whole world: ``--num_shards``
    (default: every rank) times ``--data_parallel`` must equal its size
    (fewer ranks: exit code 2, as the reference's too few devices; more:
    ``make_mesh`` raises, where the reference would take the first ones).
    Cluster-aligned row partition, per-shard tiled, hybrid or coo SpMM,
    all-gather or halo exchange, the hops propagated once, then the head
    trained ``--steps`` epochs with best-val→test selection; rank 0
    prints."""
    import numpy as np
    import torch.distributed as dist

    from ssrg_torch.configs.config import ModelConfig
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.parallel.dist_train import build_spmd_context, run_epochs_scan, run_multi
    from ssrg_torch.parallel.mesh import make_mesh
    from ssrg_torch.parallel.multihost import initialize_multihost

    if args.steps < 1:
        print(f"error: --steps must be >= 1 (got {args.steps})")
        return 2
    if args.num_runs < 1:
        print(f"error: --num_runs must be >= 1 (got {args.num_runs})")
        return 2
    with contextlib.ExitStack() as stack:
        if not dist.is_initialized():
            stack.callback(_end_world)
        initialize_multihost(device=args.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        dataset = _load_dataset(args)
        shards = args.num_shards or world
        data_par = max(args.data_parallel, 1)
        need = shards * data_par
        if world < need:
            print(f"error: mesh needs {need} devices "
                  f"({shards} graph x {data_par} data), have {world}")
            return 2
        if args.data_parallel > 1:
            mesh = make_mesh((shards, data_par), ("graph", "data"), device=args.device)
            data_axis = "data"
        else:
            mesh = make_mesh((shards,), ("graph",), device=args.device)
            data_axis = None

        model_cfg = ModelConfig(
            model_name=args.model_name, num_layers=args.num_layers,
            dropout=args.dropout, hidden_dim=args.hidden_dim,
            prop_steps=args.prop_steps, r=args.r,
        )
        spec = load_model(model_cfg, dataset.num_features, dataset.num_classes)
        adj_norm = sym_norm(dataset.adj, model_cfg.r)
        ctx = build_spmd_context(
            adj_norm, dataset.x, dataset.y, dataset.train_idx, spec.module,
            mesh, model_cfg.prop_steps, lr=args.lr,
            weight_decay=args.weight_decay, data_axis=data_axis,
            seed=args.seed, local_engine=args.local_engine, comm=args.comm,
            reorder=None if args.reorder in (None, "none") else args.reorder,
            tile_bf16=args.tile_bf16,
            val_idx=dataset.val_idx, test_idx=dataset.test_idx,
        )
        # the hops propagated once under the mesh, then --steps epochs of the
        # head with per-epoch masked val/test accuracy and best-val→test
        # selection; --num_runs > 1 adds the reference's multi-run mean±std
        if args.num_runs > 1:
            ctx, res = run_multi(ctx, args.steps, args.num_runs, seed=args.seed)
            vm, vs, tm, ts = res.mean_std
            acc_note = (f"val {vm:.4f}±{vs:.4f}, test {tm:.4f}±{ts:.4f} "
                        f"over {args.num_runs} runs")
        else:
            ctx, res = run_epochs_scan(ctx, args.steps, seed=args.seed)
            acc_note = (f"best val {res.best_val:.4f}, "
                        f"best test {res.best_test:.4f} "
                        f"(epoch {res.best_epoch + 1})")
        loss0 = float(res.history[0][0])
        loss = res.final_loss
        if mesh.rank == 0:
            print(f"spmd: mesh {dict(mesh.shape)}, engine {args.local_engine}, "
                  f"comm {args.comm}, loss {loss0:.4f} -> {loss:.4f} "
                  f"over {args.steps} epochs (hops propagated once), {acc_note}")
        return 0 if np.isfinite(loss) else 1


def cmd_sparsify(args) -> int:
    from ssrg_torch.pipelines.sparsify import run_sparsify

    run_sparsify(args)
    return 0


def cmd_augment(args) -> int:
    from ssrg_torch.pipelines.augment import run_augment

    run_augment(args)
    return 0


def cmd_baseline(args) -> int:
    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.train.baseline_task import BaselineTask

    dataset = _load_dataset(args)
    unsupported = [
        name for name in ("train_batch_size", "eval_batch_size",
                          "scan_epochs", "checkpoint_path", "resume_from",
                          "cache_dir")
        if getattr(args, name, None)
    ]
    if unsupported:
        print(f"note: the baseline task ignores {', '.join(unsupported)} "
              f"(use --cluster_parts for minibatching)")
    cfg = TrainingConfig(
        seed=args.seed, num_epochs=args.num_epochs, lr=args.lr,
        weight_decay=args.weight_decay, spmm_engine=args.spmm_engine,
    )
    task = BaselineTask(
        dataset, args.model_name, cfg, hidden_dim=args.hidden_dim,
        num_layers=args.num_layers, dropout=args.dropout, runs=args.runs,
        cluster_parts=args.cluster_parts,
        parts_per_batch=args.parts_per_batch, device=args.device,
    )
    task.logger.print_statistics()
    return 0


def cmd_link(args) -> int:
    """Link classification. With ``--data_name`` the edge-pair splits are
    held out of the file-backed graph (``data/link.py::link_dataset_from_graph``);
    otherwise a hermetic synthetic dataset is used."""
    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.data.link import link_dataset_from_graph, synthetic_link_dataset
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.train.link_classification import LinkClassification

    if args.data_name:
        from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset

        node_ds = load_homo_simplex_sparsity_dataset(
            name=args.data_name, root=args.data_root, split=args.data_split,
            surrogate_features=args.surrogate_features,
        )
        dataset = link_dataset_from_graph(
            node_ds, val_frac=args.val_frac, test_frac=args.test_frac,
            neg_ratio=args.neg_ratio, seed=args.seed,
        )
    else:
        dataset = synthetic_link_dataset(
            num_node=args.synthetic_nodes,
            num_classes=args.synthetic_classes,
            num_features=args.synthetic_features,
            num_pairs=args.num_pairs,
            seed=args.seed,
            label_mode=args.label_mode,
        )
    model_cfg = _model_config(args, edge_mode=args.edge_mode)
    train_cfg = TrainingConfig(
        seed=args.seed, normalize_times=args.normalize_times,
        num_epochs=args.num_epochs, lr=args.lr,
        weight_decay=args.weight_decay, spmm_engine=args.spmm_engine,
        warmup_epochs=args.warmup_epochs,
        train_batch_size=args.train_batch_size,
        eval_batch_size=args.eval_batch_size,
        scan_epochs=args.scan_epochs,
        checkpoint_path=args.checkpoint_path,
        resume_from=args.resume_from,
        cache_dir=args.cache_dir,
    )
    if args.checkpoint_path or args.resume_from:
        print("note: the link task does not checkpoint/resume yet; "
              "--checkpoint_path/--resume_from are ignored")
    spec = load_model(model_cfg, dataset.num_features, dataset.num_classes, link=True)
    task = LinkClassification(
        dataset, spec, model_cfg, train_cfg, verbose=args.verbose, device=args.device
    )
    print(f"Best val: {task.best_val:.4f}, best test: {task.best_test:.4f}")
    return 0


def cmd_gwnn(args) -> int:
    """Standalone GWNN pipeline: wavelet basis, then train and score."""
    import json

    from ssrg_torch.models.gwnn import (
        GWNNConfig, GWNNTrainer, WaveletSparsifier,
        read_edges_csv, read_features_json, read_targets_csv,
    )

    if args.edge_path:
        adj = read_edges_csv(args.edge_path)
        features = read_features_json(args.features_path, adj.shape[0])
        targets = read_targets_csv(args.target_path)
    else:
        from ssrg_torch.data.synthetic import sbm_graph

        g = sbm_graph(
            args.synthetic_nodes, args.synthetic_classes,
            args.synthetic_features, seed=args.seed,
        )
        adj, features, targets = g.adj, g.x, g.y

    cfg = GWNNConfig(
        epochs=args.num_epochs, filters=args.filters,
        approximation_order=args.approximation_order,
        tolerance=args.tolerance, scale=args.scale, dropout=args.dropout,
        learning_rate=args.lr, weight_decay=args.weight_decay,
        test_size=args.test_size, seed=args.seed,
    )
    # the GWNN path builds device adjacencies directly: meta-engines that
    # need the precompute pipeline resolve to auto here
    engine = args.spmm_engine
    if engine in ("autotune", "reorder_banded", "reorder_tiled"):
        engine = "auto"
    sparsifier = WaveletSparsifier(
        adj, cfg.scale, cfg.approximation_order, cfg.tolerance,
        engine=engine, device=args.device,
    )
    sparsifier.calculate_all_wavelets(verbose=args.verbose)
    trainer = GWNNTrainer(
        cfg, sparsifier, features, targets, engine=engine, device=args.device
    )
    trainer.fit(verbose=args.verbose, scan=args.scan_epochs)
    acc = trainer.score()
    print(f"Test accuracy: {acc:.4f}")
    if args.log_path:
        with open(args.log_path, "w") as f:
            json.dump(trainer.logs, f, indent=2)
    return 0


def cmd_predict(args) -> int:
    """Checkpoint-backed inference (``ssrg_torch/serve.py``)."""
    import numpy as np

    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.serve import Predictor

    dataset = _load_dataset(args)
    model_cfg = _model_config(args, edge_mode=args.edge_mode)
    spec = load_model(model_cfg, dataset.num_features, dataset.num_classes)
    pred = Predictor(
        dataset, spec, model_cfg,
        TrainingConfig(spmm_engine=args.spmm_engine),
        checkpoint_path=args.checkpoint, device=args.device,
    )
    node_ids = (
        np.asarray([int(t) for t in args.nodes.split(",")])
        if args.nodes else np.asarray(dataset.test_idx)
    )
    labels = pred.predict(node_ids).cpu().numpy()
    if args.out:
        np.save(args.out, labels)
        print(f"wrote {labels.shape[0]} predictions to {args.out}")
    else:
        print(labels.tolist())
    if pred.metadata:
        print(f"checkpoint metadata: {pred.metadata}")
    return 0


def cmd_autotune(args) -> int:
    """Per-graph SpMM engine diagnosis (``ops/autotune.py``)."""
    import json

    from ssrg_torch.ops.autotune import autotune_engine

    dataset = _load_dataset(args)
    best, timings = autotune_engine(
        dataset.adj, args.features, reps=args.reps, verbose=True, device=args.device
    )
    print(json.dumps({
        "best": best,
        "ms_per_hop": {k: round(v * 1e3, 3) for k, v in timings.items()},
        "num_nodes": int(dataset.adj.shape[0]),
        "nnz": int(dataset.adj.nnz),
    }))
    return 0


def cmd_ooc(args) -> int:
    """Out-of-core node classification: spool the adjacency from a
    memory-mapped edge file, propagate K hops block at a time, then
    minibatch-train a precompute model over the on-disk hop directories
    (O(block·F) device / O(batch·K·F) host memory)."""
    import numpy as np

    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.train.outofcore_task import run_outofcore

    model_cfg = _model_config(args)
    train_cfg = TrainingConfig(
        seed=args.seed, num_epochs=args.num_epochs, lr=args.lr,
        weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
        train_batch_size=args.train_batch_size or 512,
    )

    def _load_idx(path):
        return np.load(path) if path else None

    result = run_outofcore(
        args.edges, args.features, args.labels, args.work_dir,
        num_shards=args.num_shards, model_cfg=model_cfg,
        train_cfg=train_cfg,
        train_idx=_load_idx(args.train_idx),
        val_idx=_load_idx(args.val_idx),
        test_idx=_load_idx(args.test_idx),
        verbose=args.verbose, device=args.device,
    )
    print(f"Best val: {result.best_val:.4f}, best test: {result.best_test:.4f}")
    return 0


def cmd_bench(args) -> int:
    from ssrg_torch.bench import run_bench

    run_bench(
        num_nodes=args.nodes, avg_degree=args.degree,
        num_features=args.features, prop_steps=args.prop_steps,
        engine=args.spmm_engine, device=args.device,
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ssrg-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model (node classification)")
    _add_model_flags(p_train)
    _add_training_flags(p_train)
    _add_data_flags(p_train)
    p_train.add_argument("--verbose", action="store_true")
    _add_device_flag(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_spmd = sub.add_parser(
        "spmd", help="SPMD training over a (graph, data) mesh of ranks"
    )
    p_spmd.add_argument("--model_name", default="gamlp",
                        help="precompute-family model (sgc|ssgc|sign|gbp|"
                             "gamlp|...)")
    p_spmd.add_argument("--num_layers", type=int, default=2)
    p_spmd.add_argument("--dropout", type=float, default=0.5)
    p_spmd.add_argument("--hidden_dim", type=int, default=64)
    p_spmd.add_argument("--prop_steps", type=int, default=3)
    p_spmd.add_argument("--r", type=float, default=0.5)
    p_spmd.add_argument("--num_shards", type=int, default=None,
                        help="graph-axis size (default: every rank of the world)")
    p_spmd.add_argument("--data_parallel", type=int, default=1,
                        help=">1 adds a data axis (2-D mesh)")
    p_spmd.add_argument("--local_engine", default="tiled",
                        help="tiled|hybrid|coo per-shard SpMM layout")
    p_spmd.add_argument("--comm", default="halo",
                        help="halo|all_gather exchange mode")
    p_spmd.add_argument("--reorder", default="cluster",
                        help="cluster|none — cluster-align shard boundaries")
    p_spmd.add_argument("--tile_bf16", action="store_true",
                        help="bf16 dense-tile storage (tiled engine)")
    p_spmd.add_argument("--steps", type=int, default=100,
                        help="training epochs (head-only, over the hops "
                             "propagated once)")
    p_spmd.add_argument("--num_runs", type=int, default=1,
                        help="re-init + retrain this many times; reports "
                             "mean±std (reference multi-run protocol)")
    p_spmd.add_argument("--lr", type=float, default=0.01)
    p_spmd.add_argument("--weight_decay", type=float, default=1e-5)
    p_spmd.add_argument("--seed", type=int, default=2023)
    _add_data_flags(p_spmd)
    _add_device_flag(p_spmd)
    p_spmd.set_defaults(fn=cmd_spmd)

    p_sp = sub.add_parser("sparsify", help="sparsify a dataset (mask features/edges)")
    p_sp.add_argument("--dataset", default="cora")
    p_sp.add_argument("--dataroot", default="./datasets/simhomo/")
    p_sp.add_argument("--seed", type=int, default=2023)
    p_sp.add_argument("--sparse_rate", type=float, nargs=2, default=[0.6, 0.6])
    p_sp.add_argument("--out_root", default="./sparsity_datasets/simhomo")
    p_sp.add_argument("--synthetic", action="store_true")
    p_sp.set_defaults(fn=cmd_sparsify)

    p_aug = sub.add_parser("augment", help="repair a sparsified dataset")
    _add_data_flags(p_aug)
    p_aug.add_argument("--hidden_dim", type=int, default=256)
    p_aug.add_argument("--dropout", type=float, default=0.5)
    p_aug.add_argument("--weight_decay", type=float, default=5e-4)
    p_aug.add_argument("--lr", type=float, default=0.01)
    p_aug.add_argument("--epochs", type=int, default=200)
    p_aug.add_argument("--degree_level", type=int, default=1)
    p_aug.add_argument("--seed", type=int, default=2023)
    p_aug.add_argument("--data_save_path", default="./augument_datasets/simhomo/")
    _add_device_flag(p_aug)
    p_aug.set_defaults(fn=cmd_augment)

    p_base = sub.add_parser(
        "baseline", help="baseline message-passing pipeline (reference main.py)"
    )
    p_base.add_argument("--model_name", default="gcn",
                        help="mlp|robust_mlp|gcn|sage|gat|sgc|sign")
    p_base.add_argument("--runs", type=int, default=1)
    p_base.add_argument("--hidden_dim", type=int, default=64)
    p_base.add_argument("--num_layers", type=int, default=2)
    p_base.add_argument("--dropout", type=float, default=0.5)
    p_base.add_argument("--cluster_parts", type=int, default=None)
    p_base.add_argument("--parts_per_batch", type=int, default=8)
    _add_training_flags(p_base)
    _add_data_flags(p_base)
    _add_device_flag(p_base)
    p_base.set_defaults(fn=cmd_baseline)

    p_link = sub.add_parser(
        "link", help="link classification (reference tasks/link_classification.py)"
    )
    _add_model_flags(p_link)
    _add_training_flags(p_link)
    p_link.add_argument("--data_name", default=None,
                        help="file-backed dataset name (e.g. cora_0_0); "
                             "omit for a hermetic synthetic graph")
    p_link.add_argument("--data_root",
                        default="./sparsity_datasets/simhomo/Planetoid")
    p_link.add_argument("--data_split", default="official")
    p_link.add_argument("--surrogate_features", action="store_true",
                        help="structural features from the intact edge list")
    p_link.add_argument("--val_frac", type=float, default=0.1,
                        help="fraction of edges held out as val positives")
    p_link.add_argument("--test_frac", type=float, default=0.2,
                        help="fraction of edges held out as test positives")
    p_link.add_argument("--neg_ratio", type=float, default=1.0,
                        help="sampled non-edges per positive pair")
    p_link.add_argument("--synthetic_nodes", type=int, default=600)
    p_link.add_argument("--synthetic_classes", type=int, default=3)
    p_link.add_argument("--synthetic_features", type=int, default=32)
    p_link.add_argument("--num_pairs", type=int, default=900)
    p_link.add_argument("--label_mode", default="source_class",
                        help="source_class|same_community")
    p_link.add_argument("--verbose", action="store_true")
    _add_device_flag(p_link)
    p_link.set_defaults(fn=cmd_link)

    p_gwnn = sub.add_parser(
        "gwnn", help="standalone GWNN pipeline (reference wavelet/src/main.py)"
    )
    p_gwnn.add_argument("--edge_path", default=None,
                        help="edge-list CSV; omit for a hermetic SBM graph")
    p_gwnn.add_argument("--features_path", default=None)
    p_gwnn.add_argument("--target_path", default=None)
    p_gwnn.add_argument("--log_path", default=None,
                        help="write per-epoch JSON logs here")
    p_gwnn.add_argument("--num_epochs", type=int, default=200)
    p_gwnn.add_argument("--filters", type=int, default=32)
    p_gwnn.add_argument("--approximation_order", type=int, default=3)
    p_gwnn.add_argument("--tolerance", type=float, default=1e-4)
    p_gwnn.add_argument("--scale", type=float, default=1.0)
    p_gwnn.add_argument("--dropout", type=float, default=0.5)
    p_gwnn.add_argument("--lr", type=float, default=0.01)
    p_gwnn.add_argument("--weight_decay", type=float, default=1e-5)
    p_gwnn.add_argument("--test_size", type=float, default=0.2)
    p_gwnn.add_argument("--seed", type=int, default=42)
    p_gwnn.add_argument("--spmm_engine", default="auto")
    p_gwnn.add_argument("--scan_epochs", action="store_true",
                        help="accepted; the epochs run in the same host loop")
    p_gwnn.add_argument("--synthetic_nodes", type=int, default=600)
    p_gwnn.add_argument("--synthetic_classes", type=int, default=3)
    p_gwnn.add_argument("--synthetic_features", type=int, default=32)
    p_gwnn.add_argument("--verbose", action="store_true")
    _add_device_flag(p_gwnn)
    p_gwnn.set_defaults(fn=cmd_gwnn)

    p_pred = sub.add_parser(
        "predict", help="checkpoint-backed inference (serve.py)"
    )
    _add_model_flags(p_pred)
    _add_data_flags(p_pred)
    p_pred.add_argument("--checkpoint", required=True,
                        help="params file written by train --checkpoint_path "
                             "(of either package)")
    p_pred.add_argument("--nodes", default=None,
                        help="comma-separated node ids (default: test split)")
    p_pred.add_argument("--out", default=None, help="write labels to .npy")
    p_pred.add_argument("--seed", type=int, default=2023)
    p_pred.add_argument("--spmm_engine", default="auto")
    _add_device_flag(p_pred)
    p_pred.set_defaults(fn=cmd_predict)

    p_tune = sub.add_parser(
        "autotune", help="measure every SpMM engine on a dataset's graph"
    )
    _add_data_flags(p_tune)
    p_tune.add_argument("--features", type=int, default=128)
    p_tune.add_argument("--reps", type=int, default=8)
    p_tune.add_argument("--seed", type=int, default=2023)
    _add_device_flag(p_tune)
    p_tune.set_defaults(fn=cmd_autotune)

    p_ooc = sub.add_parser(
        "ooc", help="out-of-core training: spool -> block-at-a-time K-hop "
                    "propagate -> minibatch train (papers100M ladder)"
    )
    _add_model_flags(p_ooc)
    _add_training_flags(p_ooc)
    p_ooc.add_argument("--edges", required=True,
                       help="int64 .npy [2, E] edge file (memory-mapped)")
    p_ooc.add_argument("--features", required=True,
                       help="f32 .npy [N, F] feature file (memory-mapped)")
    p_ooc.add_argument("--labels", required=True,
                       help="int64 .npy [N] label file")
    p_ooc.add_argument("--work_dir", required=True,
                       help="spool + hop-directory root (doubles as the "
                            "precompute checkpoint; reruns skip done work)")
    p_ooc.add_argument("--num_shards", type=int, default=8)
    p_ooc.add_argument("--train_idx", default=None, help=".npy index file")
    p_ooc.add_argument("--val_idx", default=None)
    p_ooc.add_argument("--test_idx", default=None)
    p_ooc.add_argument("--verbose", action="store_true")
    _add_device_flag(p_ooc)
    p_ooc.set_defaults(fn=cmd_ooc)

    p_bench = sub.add_parser("bench", help="K-hop SpMM precompute benchmark")
    p_bench.add_argument("--nodes", type=int, default=169_343)
    p_bench.add_argument("--degree", type=float, default=13.7)
    p_bench.add_argument("--features", type=int, default=128)
    p_bench.add_argument("--prop_steps", type=int, default=3)
    p_bench.add_argument("--spmm_engine", default="auto")
    _add_device_flag(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
