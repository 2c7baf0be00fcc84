#!/usr/bin/env python
"""Example: train once with a checkpoint, then serve predictions, on the
PyTorch port.

    python examples/torch_serve_inference.py --model gamlp --epochs 100
    python examples/torch_serve_inference.py --device cpu   # without a card
"""

import argparse
import tempfile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="sgc")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import numpy as np

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.serve import Predictor
    from ssrg_torch.train import NodeClassification

    ds = planetoid_like(num_node=args.nodes, num_classes=5, num_features=64)
    mc = ModelConfig(model_name=args.model, prop_steps=3, hidden_dim=128,
                     num_layers=2)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/best.ckpt"
        tc = TrainingConfig(num_epochs=args.epochs, lr=0.01,
                            checkpoint_path=ckpt)
        spec = load_model(mc, ds.num_features, ds.num_classes)
        task = NodeClassification(ds, spec, mc, tc, device=args.device)
        print(f"trained: best val {task.best_val:.4f}, "
              f"test {task.best_test:.4f}")

        spec = load_model(mc, ds.num_features, ds.num_classes)
        pred = Predictor(ds, spec, mc, tc, checkpoint_path=ckpt, device=args.device)
        print(f"checkpoint metadata: {pred.metadata}")
        some_nodes = np.asarray(ds.test_idx)[:10]
        # the predictor answers with tensors on its device
        print(f"labels for {some_nodes.tolist()}: "
              f"{pred.predict(some_nodes).cpu().tolist()}")
        proba = pred.predict_proba(some_nodes[:1])[0].double().cpu().numpy()
        print(f"class probabilities for node {int(some_nodes[0])}: "
              f"{np.round(proba, 3).tolist()}")


if __name__ == "__main__":
    main()
