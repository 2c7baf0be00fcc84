#!/usr/bin/env python
"""Example: train a zoo model of the PyTorch port on a synthetic SBM.

    python examples/torch_train_node_classification.py --model gamlp
    python examples/torch_train_node_classification.py --model wavelet --epochs 150
    python examples/torch_train_node_classification.py --device cpu   # without a card
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="sgc")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--prop_steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.train import NodeClassification

    ds = planetoid_like(num_node=args.nodes, num_classes=5, num_features=64)
    cfg = ModelConfig(model_name=args.model, prop_steps=args.prop_steps,
                      hidden_dim=128, num_layers=2)
    tcfg = TrainingConfig(num_epochs=args.epochs, lr=args.lr)
    spec = load_model(cfg, ds.num_features, ds.num_classes)
    task = NodeClassification(ds, spec, cfg, tcfg, device=args.device)
    print(f"{args.model}: best val {task.best_val:.4f}, "
          f"best test {task.best_test:.4f} "
          f"(preprocess {task.prepared.preprocess_seconds:.2f}s)")


if __name__ == "__main__":
    main()
