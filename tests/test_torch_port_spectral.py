"""Parity of the port's spectral and directed-operator slice with
``ssrg_tpu``, on the CPU: the complex heads, the wavelet construction, layer and GWNN pipeline, the four
models through ``prepare``, ``NodeClassification`` and ``Predictor``, every
post graph op, and ``convert`` on the new parameters.

The same seeded numpy inputs go through both packages. ``estimate_lmax``
runs ``eigsh`` without a start vector, so two calls may differ within its
``tol = 5e-3``: every comparison of wavelets fixes λ_max in both packages
(:func:`fixed_lmax`). Tolerances, each with its reason:

- complex heads with carried parameters: 1e-5;
- Φ and Φ⁻¹: 1e-5, and the thresholded pattern equal except for entries
  whose float64 value lies within 1e-5 of the threshold (float32 rounding
  may put them on either side); rows holding such an entry are normalized
  by another sum, so they get 3e-4;
- the wavelet layer's output and gradients against ``jax.grad``: 1e-4;
- accuracy: the reference's bands, and the port's best test within 0.06 of
  the reference's (different initial draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
from ssrg_tpu.configs.config import TrainingConfig as RefTrainingConfig
from ssrg_tpu.configs.config import WaveletConfig as RefWaveletConfig
from ssrg_tpu.data.graph import Graph as RefGraph
from ssrg_tpu.data.synthetic import InMemoryDataset as RefInMemoryDataset
from ssrg_tpu.data.synthetic import planetoid_like as ref_planetoid_like
from ssrg_tpu.data.synthetic import sbm_graph as ref_sbm_graph
from ssrg_tpu.models import complex_heads as ref_complex
from ssrg_tpu.models import gwnn as ref_gwnn
from ssrg_tpu.models import wavelet as ref_wavelet
from ssrg_tpu.models.zoo import load_model as ref_load_model
from ssrg_tpu.ops.sparse import device_adjacency as ref_device_adjacency
from ssrg_tpu.serve import Predictor as RefPredictor
from ssrg_tpu.train import common as ref_common
from ssrg_tpu.train.node_classification import NodeClassification as RefNodeClassification
from ssrg_tpu.train.node_classification import _make_step_fns

from ssrg_torch import cache
from ssrg_torch.configs.config import ModelConfig, TrainingConfig, WaveletConfig
from ssrg_torch.convert import params_from_jax, params_to_jax
from ssrg_torch.data.graph import Graph
from ssrg_torch.data.synthetic import InMemoryDataset, planetoid_like, sbm_graph
from ssrg_torch.models import complex_heads, gwnn, wavelet
from ssrg_torch.models.zoo import load_model
from ssrg_torch.ops.sparse import DenseAdj, DifferentiableAdj, device_adjacency
from ssrg_torch.serve import Predictor
from ssrg_torch.train import common
from ssrg_torch.train.node_classification import NodeClassification, prepare

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _exact_lmax(lap, safety=1.01):
    return safety * float(np.linalg.eigvalsh(lap.toarray())[-1])


@pytest.fixture
def fixed_lmax(monkeypatch):
    """λ_max from a dense eigendecomposition in both packages."""
    monkeypatch.setattr(ref_wavelet, "estimate_lmax", _exact_lmax)
    monkeypatch.setattr(wavelet, "estimate_lmax", _exact_lmax)


def _directed(graph_cls, dataset_cls, n=400):
    """``tests/test_end_to_end.py``'s directed-signal graph: an edge mostly
    runs from class k to class k+1, features are class means plus noise,
    splits 200/100/100 (of 400)."""
    rng = np.random.default_rng(3)
    f, c = 24, 3
    y = rng.integers(0, c, n)
    src, dst = rng.integers(0, n, 10 * n), rng.integers(0, n, 10 * n)
    keep = ((y[src] + 1) % c == y[dst]) | (rng.uniform(size=10 * n) < 0.1)
    src, dst = src[keep], dst[keep]
    x = (rng.normal(size=(c, f))[y] + rng.normal(size=(n, f))).astype(np.float32)
    g = graph_cls(src, dst, np.ones(src.shape[0], np.float32), n, "UUU", x=x, y=y,
                  symmetrize=False)
    perm = rng.permutation(n)
    half, rest = n // 2, n // 4
    return dataset_cls(g, perm[:half], perm[half:half + rest], perm[half + rest:],
                       name="directed")


@pytest.fixture(scope="module")
def directed():
    return _directed(RefGraph, RefInMemoryDataset), _directed(Graph, InMemoryDataset)


@pytest.fixture(scope="module")
def sbm():
    kw = dict(num_node=300, num_classes=3, num_features=24, seed=4)
    return ref_planetoid_like(**kw), planetoid_like(**kw)


# --- complex heads ----------------------------------------------------------------

RE_IM = tuple(np.random.default_rng(2).normal(size=(2, 37, 12)).astype(np.float32))

COMPLEX_HEADS = {  # name: (flax module, port module)
    "logreg": (lambda: ref_complex.ComLogisticRegression(output_dim=5),
               lambda: complex_heads.ComLogisticRegression(12, 5)),
    "mlp2": (lambda: ref_complex.ComMLP(hidden_dim=16, output_dim=5),
             lambda: complex_heads.ComMLP(12, 16, 5)),
    "mlp3": (lambda: ref_complex.ComMLP(hidden_dim=16, output_dim=5, num_layers=3),
             lambda: complex_heads.ComMLP(12, 16, 5, num_layers=3)),
    "mlp1": (lambda: ref_complex.ComMLP(hidden_dim=16, output_dim=5, num_layers=1),
             lambda: complex_heads.ComMLP(12, 16, 5, num_layers=1)),
}


@pytest.mark.parametrize("name", sorted(COMPLEX_HEADS))
def test_complex_head_matches_flax(name):
    make_ref, make_port = COMPLEX_HEADS[name]
    ref, port = make_ref(), make_port()
    variables = ref.init(jax.random.PRNGKey(1), RE_IM)
    want = ref.apply(variables, RE_IM)
    port.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    with torch.no_grad():
        got = port.eval()(tuple(torch.from_numpy(a) for a in RE_IM))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_complex_linear_and_relu_match_flax():
    ref, port = ref_complex.ComplexLinear(features=7), complex_heads.ComplexLinear(12, 7)
    variables = ref.init(jax.random.PRNGKey(3), *RE_IM)
    want = ref.apply(variables, *RE_IM)
    port.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    got = port(*(torch.from_numpy(a) for a in RE_IM))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for g, w in zip(complex_heads.complex_relu(*(torch.from_numpy(a) for a in RE_IM)),
                    ref_complex.complex_relu(*RE_IM)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_complex_linear_init_is_xavier_uniform_from_the_generator():
    flax_w = np.asarray(ref_complex.ComplexLinear(features=64).init(
        jax.random.PRNGKey(0), np.zeros((2, 128), np.float32), np.zeros((2, 128), np.float32))
        ["params"]["w_re"])
    layers = [complex_heads.ComplexLinear(128, 64) for _ in range(2)]
    for layer in layers:
        layer.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(layers[0].w_im, layers[1].w_im)
    assert not torch.equal(layers[0].w_re, layers[0].w_im)
    assert not layers[0].b_re.any() and not layers[0].b_im.any()
    limit = np.sqrt(6.0 / (128 + 64))
    for sample in (flax_w, layers[0].w_re.detach().numpy()):
        assert np.abs(sample).max() <= limit
        assert abs(sample.std() / (limit / np.sqrt(3.0)) - 1.0) < 0.05


# --- the wavelet construction ---------------------------------------------------------


def _small_graph(n=200, seed=2):
    return sbm_graph(n, 3, 4, p_in=0.06, p_out=0.01, seed=seed).adj


def test_cheby_pieces_match_reference():
    adj = _small_graph()
    lap, ref_lap = wavelet.combinatorial_laplacian(adj), ref_wavelet.combinatorial_laplacian(adj)
    assert (lap != ref_lap).nnz == 0
    lmax = _exact_lmax(lap)
    for tau, order in ((0.5, 3), (-0.5, 3), (1.0, 12)):
        np.testing.assert_array_equal(wavelet.compute_cheby_coeff(tau, lmax, order),
                                      ref_wavelet.compute_cheby_coeff(tau, lmax, order))
        block = np.eye(adj.shape[0], 64, k=-5, dtype=np.float32)
        want = ref_wavelet.cheby_op_batch(ref_device_adjacency(ref_lap.astype(np.float32),
                                                               "dense"),
                                          wavelet.compute_cheby_coeff(tau, lmax, order),
                                          jnp.asarray(block), lmax)
        got = wavelet.cheby_op_batch(device_adjacency(lap.astype(np.float32), "dense",
                                                      device=CPU),
                                     wavelet.compute_cheby_coeff(tau, lmax, order),
                                     torch.from_numpy(block), lmax)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _raw_heat(adj, tau, lmax, order):
    """The float64 Chebyshev evaluation of the whole basis before the
    threshold."""
    lap = wavelet.combinatorial_laplacian(adj).toarray()
    c = wavelet.compute_cheby_coeff(tau, lmax, order)
    a = lmax / 2.0
    t_prev = np.eye(lap.shape[0])
    t_cur = (lap @ t_prev - a * t_prev) / a
    out = 0.5 * c[0] * t_prev + c[1] * t_cur
    for k in range(2, len(c)):
        t_prev, t_cur = t_cur, 2.0 * (lap @ t_cur - a * t_cur) / a - t_prev
        out += c[k] * t_cur
    return out


def _assert_basis_close(got, want, raw, tol):
    g, w = got.toarray(), want.toarray()
    flipped = (g != 0) != (w != 0)
    assert (np.abs(raw[flipped] - tol) <= 1e-5).all(), raw[flipped]
    rows = flipped.any(axis=1)
    np.testing.assert_allclose(g[~rows], w[~rows], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g[rows], w[rows], atol=3e-4)


@pytest.mark.parametrize("engine", ["dense", "hybrid"])
def test_calculate_wavelets_matches_reference(fixed_lmax, engine):
    """Impulse blocks of 64 columns over 200 nodes (the last one ragged);
    the hybrid engine runs the Laplacian through the ELL path at F = 64."""
    adj = _small_graph()
    cfg = dict(approximation_order=3, tolerance=1e-4, scale=0.5, impulse_batch=64)
    phi, phi_inv, stats = wavelet.calculate_wavelets(adj, WaveletConfig(**cfg), engine,
                                                     verbose=False, device=CPU)
    ref_phi, ref_inv, ref_stats = ref_wavelet.calculate_wavelets(adj, RefWaveletConfig(**cfg),
                                                                 engine, verbose=False)
    lmax = stats["lmax"]
    assert lmax == ref_stats["lmax"]
    for got, want, tau in ((phi, ref_phi, -0.5), (phi_inv, ref_inv, 0.5)):
        assert got.dtype == np.float32 and got.shape == (200, 200)
        _assert_basis_close(got, want, _raw_heat(adj, tau, lmax, 3), 1e-4)
        rowsum = np.abs(got).sum(axis=1).A.reshape(-1)
        np.testing.assert_allclose(rowsum[rowsum > 0], 1.0, rtol=1e-5)
        assert (got.data > 0).all()   # the threshold zeroes negative entries too
    for key in ("phi_density", "phi_inv_density"):
        assert abs(stats[key] - ref_stats[key]) <= 100.0 * 4 / 200**2
    assert stats["recurrence_s"] > 0 and stats["threshold_s"] > 0


def test_wavelet_guard_refuses_at_the_same_size():
    adj = _small_graph()
    messages = []
    for fn, cfg in ((wavelet.calculate_wavelets, WaveletConfig(max_nodes=199)),
                    (ref_wavelet.calculate_wavelets, RefWaveletConfig(max_nodes=199))):
        kwargs = dict(device=CPU) if fn is wavelet.calculate_wavelets else {}
        with pytest.raises(ValueError, match="max_nodes=199") as err:
            fn(adj, cfg, verbose=False, **kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "sgc" in messages[0]


def test_prepare_spectral_packs_phi_for_autograd(fixed_lmax):
    """Above the dense engine, Φ and Φ⁻¹ come back under autograd with a
    pack of their own transposes (neither is symmetric)."""
    phi, phi_inv = wavelet.prepare_spectral(_small_graph(), WaveletConfig(), "hybrid",
                                            device=CPU)
    for adj in (phi, phi_inv):
        assert isinstance(adj, DifferentiableAdj) and not adj.symmetric
    dense = wavelet.prepare_spectral(_small_graph(), WaveletConfig(), "auto", device=CPU)
    assert all(isinstance(a, DenseAdj) for a in dense)


# --- the wavelet layer and model ----------------------------------------------------------


@pytest.fixture(scope="module")
def basis():
    """(Φ, Φ⁻¹) of a 120-node graph, one scipy pair for both packages."""
    adj = sbm_graph(120, 3, 4, p_in=0.08, p_out=0.01, seed=6).adj
    cfg = WaveletConfig()
    lmax = _exact_lmax(wavelet.combinatorial_laplacian(adj))
    orig = wavelet.estimate_lmax
    wavelet.estimate_lmax = lambda lap, safety=1.01: lmax
    try:
        phi, phi_inv, _ = wavelet.calculate_wavelets(adj, cfg, verbose=False, device=CPU)
    finally:
        wavelet.estimate_lmax = orig
    return phi, phi_inv


def _device_pair(basis, engine, ours):
    if ours:
        from ssrg_torch.ops.sparse import differentiable_adjacency

        return tuple(differentiable_adjacency(m, engine, device=CPU) for m in basis)
    return tuple(ref_device_adjacency(m, engine) for m in basis)


@pytest.mark.parametrize("engine", ["dense", "hybrid"])
def test_wavelet_model_output_and_gradients_match_jax_grad(basis, engine):
    """Wavelet2NeuralNetwork's logits and the gradient of its training loss
    (cross entropy on 40 rows, no dropout) for every parameter."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 10)).astype(np.float32)
    y = rng.integers(0, 3, 120)
    rows = np.arange(0, 120, 3)
    ref = ref_wavelet.Wavelet2NeuralNetwork(hidden_dim=16, output_dim=3, dropout=0.0)
    ref_adj = _device_pair(basis, engine, ours=False)
    variables = ref.init(jax.random.PRNGKey(0), x, ref_adj)

    def loss_fn(params):
        logits = ref.apply({"params": params}, x, ref_adj)
        return ref_common.cross_entropy_loss(logits[rows], jnp.asarray(y[rows])), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    port = wavelet.Wavelet2NeuralNetwork(10, 16, 3, dropout=0.0, num_nodes=120)
    port.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    logits = port.train()(torch.from_numpy(x), _device_pair(basis, engine, ours=True))
    loss = common.cross_entropy_loss(logits[rows], torch.from_numpy(y[rows]))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    grads = dict(port.named_parameters())
    want = params_from_jax(_np_tree(ref_grads))
    assert set(want) == {"conv1.theta", "conv1.weight", "conv2.theta", "conv2.weight"}
    for k, v in want.items():
        assert bool(grads[k].grad.abs().sum() > 0), k
        np.testing.assert_allclose(grads[k].grad.numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_wavelet_layer_is_the_spspmm_chain(basis):
    """Φ (θ ⊙ (Φ⁻¹ (X W))) equals (Φ diag(θ) Φ⁻¹)(X W) in float64."""
    layer = wavelet.GraphWaveletLayer(10, 5, num_nodes=120, apply_act=False)
    layer.reset_parameters(torch.Generator().manual_seed(2))
    theta = layer.theta.detach().numpy().reshape(-1)
    assert 0.9 <= theta.min() and theta.max() <= 1.1
    assert np.abs(layer.weight.detach().numpy()).max() <= np.sqrt(3 * 2.0 / 7.5)
    x = np.random.default_rng(1).normal(size=(120, 10)).astype(np.float32)
    got = layer(torch.from_numpy(x), *_device_pair(basis, "dense", ours=True))
    phi, inv = (m.toarray().astype(np.float64) for m in basis)
    want = (phi @ np.diag(theta) @ inv) @ (x @ layer.weight.detach().numpy().astype(np.float64))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="set_num_nodes"):
        wavelet.GraphWaveletLayer(10, 5, num_nodes=7)(torch.from_numpy(x),
                                                      *_device_pair(basis, "dense", True))


# --- the GWNN pipeline --------------------------------------------------------------


def _write_gwnn_dataset(tmp_path, n=150, seed=3):
    """An SBM in the GWNN sub-project's files: edges CSV, features JSON,
    targets CSV."""
    import json

    g = ref_sbm_graph(n, 3, 20, p_in=0.08, p_out=0.01, seed=seed)
    coo = g.adj.tocoo()
    half = coo.row < coo.col
    paths = {name: tmp_path / name for name in ("edges.csv", "features.json", "target.csv")}
    with open(paths["edges.csv"], "w") as fh:
        fh.write("id1,id2\n" + "".join(f"{a},{b}\n" for a, b in
                                       zip(coo.row[half], coo.col[half])))
    with open(paths["features.json"], "w") as fh:
        json.dump({str(i): np.where(g.x[i] > 0.5)[0].tolist() for i in range(n)}, fh)
    with open(paths["target.csv"], "w") as fh:
        fh.write("id,target\n" + "".join(f"{i},{g.y[i]}\n" for i in range(n)))
    return {k: str(v) for k, v in paths.items()}, g


def test_gwnn_readers_match_reference(tmp_path):
    paths, g = _write_gwnn_dataset(tmp_path)
    adj = gwnn.read_edges_csv(paths["edges.csv"])
    assert (adj != ref_gwnn.read_edges_csv(paths["edges.csv"])).nnz == 0
    assert (adj != g.adj).nnz == 0 and adj.dtype == np.float32
    x = gwnn.read_features_json(paths["features.json"], adj.shape[0])
    np.testing.assert_array_equal(x, ref_gwnn.read_features_json(paths["features.json"],
                                                                 adj.shape[0]))
    np.testing.assert_array_equal(x, gwnn.read_features_json(paths["features.json"]))
    y = gwnn.read_targets_csv(paths["target.csv"])
    np.testing.assert_array_equal(y, ref_gwnn.read_targets_csv(paths["target.csv"]))
    np.testing.assert_array_equal(y, g.y)


@pytest.mark.parametrize("scan", [False, True], ids=["loop", "scan"])
def test_gwnn_trainer_split_logs_and_score(tmp_path, fixed_lmax, scan):
    """The reference's split (same numpy seed), one log entry an epoch, a
    falling NLL and the reference test's score band."""
    paths, _ = _write_gwnn_dataset(tmp_path)
    adj = gwnn.read_edges_csv(paths["edges.csv"])
    x = gwnn.read_features_json(paths["features.json"], adj.shape[0])
    y = gwnn.read_targets_csv(paths["target.csv"])
    cfg = gwnn.GWNNConfig(epochs=120, filters=16, learning_rate=0.02)
    sparsifier = gwnn.WaveletSparsifier(adj, cfg.scale, cfg.approximation_order,
                                        cfg.tolerance, device=CPU)
    sparsifier.calculate_all_wavelets()
    assert len(sparsifier.phi_matrices) == 2 and sparsifier.stats["phi_density"] > 0
    ref_sparsifier = ref_gwnn.WaveletSparsifier(adj, cfg.scale, cfg.approximation_order,
                                                cfg.tolerance)
    ref_sparsifier.calculate_all_wavelets()
    for got, want in zip(sparsifier.phi_matrices, ref_sparsifier.phi_matrices):
        np.testing.assert_allclose(got.toarray(), want.toarray(), atol=3e-4)
    trainer = gwnn.GWNNTrainer(cfg, sparsifier, x, y, device=CPU)
    ref_trainer = ref_gwnn.GWNNTrainer(ref_gwnn.GWNNConfig(epochs=120, filters=16,
                                                           learning_rate=0.02),
                                       ref_sparsifier, x, y)
    np.testing.assert_array_equal(trainer.test_idx.numpy(), np.asarray(ref_trainer.test_idx))
    np.testing.assert_array_equal(trainer.train_idx.numpy(), np.asarray(ref_trainer.train_idx))
    trainer.fit(scan=scan)
    assert [entry["epoch"] for entry in trainer.logs] == list(range(cfg.epochs))
    assert all(entry["seconds"] > 0 for entry in trainer.logs)
    losses = [entry["loss"] for entry in trainer.logs]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert trainer.score() > 0.5


# --- the models through prepare, NodeClassification and Predictor ----------------------

DIRECTED_KW = dict(hidden_dim=32, prop_steps=2, num_layers=2, dropout=0.1, q=0.1)


@pytest.mark.parametrize("engine", ["dense", "hybrid"])
@pytest.mark.parametrize("name", ["magnet", "two_dir", "two_order"])
def test_prepare_matches_reference(directed, name, engine):
    ref_ds, ds = directed
    ref_cfg, cfg = RefModelConfig(model_name=name, **DIRECTED_KW), ModelConfig(
        model_name=name, **DIRECTED_KW)
    from ssrg_tpu.train.node_classification import prepare as ref_prepare

    want = ref_prepare(ref_load_model(ref_cfg, 24, 3), ref_ds, ref_cfg,
                       RefTrainingConfig(spmm_engine=engine)).inputs
    got = prepare(load_model(cfg, 24, 3), ds, cfg, TrainingConfig(spmm_engine=engine),
                  device=CPU)
    assert not got.hops_layout and got.adj_device is None
    if name == "magnet":
        assert isinstance(got.inputs, tuple) and len(got.inputs) == 2
    for g, w in zip(got.inputs if name == "magnet" else (got.inputs,),
                    want if name == "magnet" else (want,)):
        assert g.shape == (400, {"magnet": 24, "two_dir": 72, "two_order": 48}[name])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path,name", [("spectral", "wavelet"), ("tuple-adjacency", "magnet")])
def test_meta_engines_degrade_to_auto_with_a_warning(sbm, fixed_lmax, caplog, path, name):
    import logging

    _, ds = sbm
    cfg = ModelConfig(model_name=name, hidden_dim=8)
    with caplog.at_level(logging.WARNING, logger="ssrg_torch"):
        p = prepare(load_model(cfg, 24, 3), ds, cfg, TrainingConfig(spmm_engine="reorder_banded"),
                    device=CPU)
    assert p.engine == "auto"
    assert any(path in r.getMessage() and "reorder_banded" in r.getMessage()
               for r in caplog.records)
    if name == "wavelet":
        assert all(isinstance(a, DenseAdj) for a in p.adj_device)
        assert p.module.head.conv1.theta.shape == (300, 1)


ACCURACY = {  # name: (dataset, model config, training config, band)
    "magnet": ("directed", DIRECTED_KW, dict(num_epochs=120, lr=0.01, seed=5), 0.6),
    "two_dir": ("directed", DIRECTED_KW, dict(num_epochs=120, lr=0.01, seed=5), 0.6),
    "two_order": ("directed", DIRECTED_KW, dict(num_epochs=120, lr=0.01, seed=5), 0.45),
    "wavelet": ("sbm", dict(hidden_dim=32, dropout=0.3), dict(num_epochs=80, lr=0.01, seed=1),
                0.7),
}


@pytest.mark.parametrize("name", sorted(ACCURACY))
def test_accuracy_band_and_reference(directed, sbm, fixed_lmax, name):
    which, mkw, tkw, band = ACCURACY[name]
    ref_ds, ds = {"directed": directed, "sbm": sbm}[which]
    ref_cfg = RefModelConfig(model_name=name, **mkw)
    want = RefNodeClassification(ref_ds, ref_load_model(ref_cfg, 24, 3), ref_cfg,
                                 RefTrainingConfig(**tkw)).best_test
    cfg = ModelConfig(model_name=name, **mkw)
    task = NodeClassification(ds, load_model(cfg, 24, 3), cfg, TrainingConfig(**tkw), device=CPU)
    assert task.best_test > band, f"{name}: {task.best_test:.3f}"
    assert abs(task.best_test - want) <= 0.06, (task.best_test, want)
    assert max(task.history["val_acc"]) == task.best_val


def _postprocess_pair(ds_pair, post_graph_op):
    """The reference's and the port's ``_postprocess`` on one SGC model
    with the same parameters."""
    ref_ds, ds = ds_pair
    ref_cfg, cfg = RefModelConfig(model_name="sgc", prop_steps=2), ModelConfig(
        model_name="sgc", prop_steps=2)
    ref_task = RefNodeClassification(ref_ds, ref_load_model(ref_cfg, 24, 3), ref_cfg,
                                     RefTrainingConfig(), post_graph_op=post_graph_op, run=False)
    p = ref_task.prepared
    ref_state = ref_common.create_train_state(p.module, jax.random.PRNGKey(0),
                                              np.asarray(p.inputs)[:2], 0.01, 0.0)
    eval_step = _make_step_fns(p.module, None, False)[1]
    return ref_task, ref_state, eval_step, cfg


@pytest.mark.parametrize("op", ["sym", "ppr", "fast_ppr"])
def test_postprocess_matches_reference(directed, op):
    ref_task, ref_state, eval_step, cfg = _postprocess_pair(directed, op)
    want = ref_task._postprocess(ref_state, eval_step)
    task = NodeClassification(directed[1], load_model(cfg, 24, 3), cfg, TrainingConfig(),
                              post_graph_op=op, run=False, device=CPU)
    task.prepared.module.load_state_dict(params_from_jax(_np_tree(ref_state.params)))
    got = task._postprocess(common.create_train_state(task.prepared.module, torch.Generator(),
                                                      0.01, 0.0))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("op", ["magnetic", "magnetic_ppr", "two_dir", "two_order"])
def test_tuple_post_graph_op_refuses(directed, op):
    """Label propagation needs one adjacency: the reference fails in its
    postprocess (``device_adjacency`` of a tuple), the port at construction."""
    ref_task, ref_state, eval_step, cfg = _postprocess_pair(directed, op)
    with pytest.raises(AttributeError):
        ref_task._postprocess(ref_state, eval_step)
    with pytest.raises(ValueError, match="tuple of adjacencies"):
        NodeClassification(directed[1], load_model(cfg, 24, 3), cfg, TrainingConfig(),
                           post_graph_op=op, run=False, device=CPU)


SERVED = {  # name: (dataset, model config)
    "magnet": ("directed", dict(hidden_dim=16, prop_steps=2, num_layers=3, q=0.1)),
    "wavelet": ("sbm", dict(hidden_dim=16)),
}


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("name", sorted(SERVED))
def test_predictor_serves_checkpoints_both_ways(directed, sbm, fixed_lmax, tmp_path, name,
                                                direction):
    which, mkw = SERVED[name]
    ref_ds, ds = {"directed": directed, "sbm": sbm}[which]
    ckpt = str(tmp_path / "model.ckpt")
    ref_cfg, cfg = RefModelConfig(model_name=name, **mkw), ModelConfig(model_name=name, **mkw)
    if direction == "reference_to_port":
        RefNodeClassification(ref_ds, ref_load_model(ref_cfg, 24, 3), ref_cfg,
                              RefTrainingConfig(num_epochs=6, lr=0.05, checkpoint_path=ckpt))
    else:
        NodeClassification(ds, load_model(cfg, 24, 3), cfg,
                           TrainingConfig(num_epochs=6, lr=0.05, checkpoint_path=ckpt),
                           device=CPU)
    assert cache.load_metadata(ckpt)["model"] == name
    ref = RefPredictor(ref_ds, ref_load_model(ref_cfg, 24, 3), ref_cfg, RefTrainingConfig(),
                       checkpoint_path=ckpt)
    got = Predictor(ds, load_model(cfg, 24, 3), cfg, TrainingConfig(), checkpoint_path=ckpt,
                    device=CPU)
    assert got.num_nodes == ds.num_node
    ids = np.concatenate([ds.test_idx, [0, ds.num_node - 1]])
    logits = got.logits(ids)
    assert logits.shape == (ids.size, 3)
    np.testing.assert_allclose(logits.numpy(), ref.logits(ids), rtol=1e-4, atol=1e-4)
    assert torch.equal(got.predict(ids), logits.argmax(dim=-1))


# --- convert ----------------------------------------------------------------------------

TREES = {  # name: (flax module, port module, example inputs)
    "wavelet": (lambda: ref_wavelet.Wavelet2NeuralNetwork(hidden_dim=6, output_dim=3),
                lambda: wavelet.Wavelet2NeuralNetwork(5, 6, 3, num_nodes=30),
                lambda adj: (np.ones((30, 5), np.float32), adj)),
    "gwnn": (lambda: ref_gwnn.GraphWaveletNeuralNetwork(filters=6, output_dim=3),
             lambda: gwnn.GraphWaveletNeuralNetwork(5, 6, 3, num_nodes=30),
             lambda adj: (np.ones((30, 5), np.float32), *adj)),
    "com_mlp": (lambda: ref_complex.ComMLP(hidden_dim=6, output_dim=3, num_layers=3),
                lambda: complex_heads.ComMLP(5, 6, 3, num_layers=3),
                lambda adj: ((np.ones((4, 5), np.float32), np.ones((4, 5), np.float32)),)),
    "com_logreg": (lambda: ref_complex.ComLogisticRegression(output_dim=3),
                   lambda: complex_heads.ComLogisticRegression(5, 3),
                   lambda adj: ((np.ones((4, 5), np.float32), np.ones((4, 5), np.float32)),)),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_convert_round_trip_against_flax_trees(name):
    """flax tree -> state dict -> flax tree gives the same tree, leaf for
    leaf; the wavelet ``weight`` keeps its name and its [in, out] layout."""
    make_ref, make_port, inputs = TREES[name]
    eye = sp.identity(30, format="csr", dtype=np.float32)
    adj = (ref_device_adjacency(eye, "dense"), ref_device_adjacency(eye, "dense"))
    tree = _np_tree(make_ref().init(jax.random.PRNGKey(0), *inputs(adj))["params"])
    port = make_port()
    port.load_state_dict(params_from_jax(tree), strict=True)
    back = params_to_jax(port.state_dict())
    assert set(back) == {"params"}
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back["params"]),
                            jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b), path
    if name in ("wavelet", "gwnn"):
        layer = port.conv1 if name == "wavelet" else port.sparse_layer
        assert layer.weight.shape == (5, 6) and layer.theta.shape == (30, 1)
