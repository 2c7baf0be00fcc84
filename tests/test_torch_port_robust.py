"""Parity of the port's robustness pipeline and link task with ``ssrg_tpu``,
on the CPU.

The same seeded numpy inputs go through the reference and the port; flax
parameters are carried across with ``ssrg_torch.convert``. Tolerances, each
with its reason:

- sparsification, ``edge_augment``, the link splits: exactly equal (the
  same numpy draws in the same order); raw directories written by either
  package read back by the other with equal arrays;
- link heads, every head and ``edge_mode``: logits 1e-5 and parameter
  gradients 1e-4 of ``jax.grad`` (float32 products and sums in other
  orders);
- ``feature_augment`` with dropout 0 and the reference's initial parameters
  carried across: the augmented features within 1e-4 after 5 Adam epochs;
- training (``TrainModel``, ``LinkClassification`` full batch and
  minibatch, the sparsify -> augment -> train round trip): the JAX tests'
  accuracy bands, and the port's best test accuracy within 0.06 of the
  reference's on the same configuration (different random initializations
  and dropout draws).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu.configs.config import DataAugmentConfig as RefDataAugmentConfig
from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
from ssrg_tpu.configs.config import TrainingConfig as RefTrainingConfig
from ssrg_tpu.data.link import link_dataset_from_graph as ref_link_dataset_from_graph
from ssrg_tpu.data.link import synthetic_link_dataset as ref_synthetic_link_dataset
from ssrg_tpu.data.sparsity import load_homo_simplex_sparsity_dataset as ref_load_sparsity
from ssrg_tpu.data.synthetic import planetoid_like as ref_planetoid_like
from ssrg_tpu.models import heads as ref_heads
from ssrg_tpu.models import wavelet as ref_wavelet
from ssrg_tpu.models.zoo import load_model as ref_load_model
from ssrg_tpu.ops.sparse import DenseAdj as RefDenseAdj
from ssrg_tpu.pipelines import augment as ref_augment
from ssrg_tpu.pipelines import sparsify as ref_sparsify
from ssrg_tpu.train.augment_train import TrainModel as RefTrainModel
from ssrg_tpu.train.link_classification import LinkClassification as RefLinkClassification
from ssrg_tpu.train.node_classification import NodeClassification as RefNodeClassification

from ssrg_torch.configs.config import DataAugmentConfig, ModelConfig, TrainingConfig
from ssrg_torch.convert import params_from_jax, params_to_jax
from ssrg_torch.data.graph import Graph
from ssrg_torch.data.link import link_dataset_from_graph, synthetic_link_dataset
from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset
from ssrg_torch.data.synthetic import planetoid_like
from ssrg_torch.models import heads, wavelet
from ssrg_torch.models.zoo import MODEL_REGISTRY, load_model
from ssrg_torch.ops.sparse import DenseAdj
from ssrg_torch.pipelines import augment, sparsify
from ssrg_torch.train import LinkClassification, NodeClassification, TrainModel

CPU = "cpu"
N, F, H, C = 30, 12, 16, 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's tensors, which are small here: in a
    parallel run each worker shares the host's cores with the others, and
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def base():
    kw = dict(num_node=600, num_classes=3, num_features=32, seed=5)
    return ref_planetoid_like(**kw), planetoid_like(**kw)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


# --- sparsification ---------------------------------------------------------------


def test_feature_masked_matches():
    x = np.random.default_rng(0).normal(size=(200, 30)).astype(np.float64)
    ours = sparsify.feature_masked(x, 0.7, np.random.default_rng(3))
    ref = ref_sparsify.feature_masked(x, 0.7, np.random.default_rng(3))
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert abs(ours[0].mean() - 0.3) < 0.02


@pytest.mark.parametrize("targeted", [False, True], ids=["random", "heterophilous"])
def test_edge_masked_matches(base, targeted):
    ref_ds, _ = base
    coo = ref_ds.adj.tocoo()
    y = np.asarray(ref_ds.y)
    ours = sparsify.edge_masked(coo.row, coo.col, 0.4, np.random.default_rng(1), labels=y,
                                target_heterophilous=targeted)
    ref = ref_sparsify.edge_masked(coo.row, coo.col, 0.4, np.random.default_rng(1), labels=y,
                                   target_heterophilous=targeted)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    half = int((coo.col > coo.row).sum())
    assert ours[1].shape == (2, half - int(0.4 * half)) and (ours[1][1] > ours[1][0]).all()


def _read_raw(raw):
    return {f: torch.load(os.path.join(raw, f), weights_only=True) for f in sorted(os.listdir(raw))}


def test_sparsify_dataset_matches_and_crosses_packages(base, tmp_path):
    """One seed gives the same eight files in both packages, and each
    package's loader reads the other's directory to the same arrays."""
    ref_ds, ds = base
    ref_raw = ref_sparsify.sparsify_dataset(ref_ds, 0.5, 0.5, str(tmp_path / "ref" / "sbm"), 1)
    raw = sparsify.sparsify_dataset(ds, 0.5, 0.5, str(tmp_path / "port" / "sbm"), seed=1)
    ref_files, files = _read_raw(ref_raw), _read_raw(raw)
    assert list(files) == list(ref_files) and len(files) == 8
    for name in files:
        assert files[name].dtype == ref_files[name].dtype, name
        assert torch.equal(files[name], ref_files[name]), name
    ours = load_homo_simplex_sparsity_dataset("sbm", str(tmp_path / "ref"))
    theirs = ref_load_sparsity("sbm", str(tmp_path / "port"))
    for attr in ("x", "y", "feature_mask", "edge_mask", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(ours, attr)),
                                      np.asarray(getattr(theirs, attr)), err_msg=attr)
    assert (ours.adj != theirs.adj).nnz == 0 and (ours.adj != ours.adj.T).nnz == 0
    orig_und, kept_und = ds.adj.nnz // 2, ours.adj.nnz // 2
    assert 0.35 * orig_und < kept_und < 0.65 * orig_und
    np.testing.assert_array_equal(ours.train_idx, ds.train_idx)


# --- link heads -------------------------------------------------------------------------

MODES = ("concat", "hadamard")
RNG = np.random.default_rng(11)
X = RNG.normal(size=(N, F)).astype(np.float32)
PAIRS = RNG.integers(0, N, (40, 2)).astype(np.int64)
LABELS = RNG.integers(0, C, 40).astype(np.int64)
_A = sp.random(N, N, density=0.2, random_state=3, dtype=np.float64)
ADJ = ((_A + _A.T) * 0.3).toarray().astype(np.float32)
PHI = (np.eye(N) + 0.1 * RNG.uniform(size=(N, N)) * (RNG.uniform(size=(N, N)) < 0.2)
       ).astype(np.float32)
PHI_INV = (np.eye(N) - 0.05 * RNG.uniform(size=(N, N)) * (RNG.uniform(size=(N, N)) < 0.2)
           ).astype(np.float32)


def _link_cases(mode):
    """name -> (flax module, port module, extra flax args, extra port
    args), built for ``mode``: the logistic regression and the MLP honour
    it, the residual MLP, the GCN and the wavelet head concatenate."""
    ref_adj, adj = RefDenseAdj(jnp.asarray(ADJ)), DenseAdj(torch.from_numpy(ADJ))
    ref_pair = (RefDenseAdj(jnp.asarray(PHI)), RefDenseAdj(jnp.asarray(PHI_INV)))
    pair = (DenseAdj(torch.from_numpy(PHI)), DenseAdj(torch.from_numpy(PHI_INV)))
    return {
        "logreg": (ref_heads.LogisticRegression(output_dim=C, edge_mode=mode),
                   heads.LogisticRegression(F, C, link=True, edge_mode=mode), (), ()),
        "mlp": (ref_heads.MultiLayerPerceptron(hidden_dim=H, output_dim=C, num_layers=3,
                                               edge_mode=mode),
                heads.MultiLayerPerceptron(F, H, C, num_layers=3, link=True, edge_mode=mode),
                (), ()),
        "resmlp": (ref_heads.ResMultiLayerPerceptron(hidden_dim=H, output_dim=C, num_layers=3),
                   heads.ResMultiLayerPerceptron(F, H, C, num_layers=3, link=True), (), ()),
        "gcn": (ref_heads.Layer2GraphConvolution(hidden_dim=H, output_dim=C),
                heads.Layer2GraphConvolution(F, H, C, link=True), (ref_adj,), (adj,)),
        "wavelet": (ref_wavelet.Wavelet2NeuralNetwork(hidden_dim=H, output_dim=C),
                    wavelet.Wavelet2NeuralNetwork(F, H, C, num_nodes=N, link=True),
                    (ref_pair,), (pair,)),
    }


EXPECTED_TREES = {
    "logreg": {"fc", "edge_fc"},
    "mlp": {"fc_0", "prelu_0", "fc_1", "prelu_1", "edge_fc"},
    "resmlp": {"fc_0", "fc_1", "edge_fc"},
    "gcn": {"fc1", "fc2_edge", "edge_fc"},
    "wavelet": {"conv1", "conv2", "edge_fc"},
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(EXPECTED_TREES))
def test_link_head_matches_flax(name, mode):
    """Logits of the pairs (evaluation mode) within 1e-5 and the gradient of
    the pairs' cross entropy with respect to every parameter within 1e-4 of
    ``jax.grad``, with the flax parameters carried across both ways."""
    ref, port, ref_args, args = _link_cases(mode)[name]
    q = jnp.asarray(PAIRS)
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(X), *ref_args, query_edges=q)["params"]
    assert set(params) == EXPECTED_TREES[name]
    port.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    back = params_to_jax(port.state_dict())["params"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(a, b)), back, _np_tree(params)))

    def loss(p):
        logits = ref.apply({"params": p}, jnp.asarray(X), *ref_args, query_edges=q)
        return optax.softmax_cross_entropy_with_integer_labels(logits, LABELS).mean(), logits

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port.eval()
    logits = port(torch.from_numpy(X), *args, query_edges=torch.from_numpy(PAIRS))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(LABELS)).backward()
    ref_grads = params_from_jax(_np_tree(grads))
    named = dict(port.named_parameters())
    assert set(ref_grads) == set(named)
    for key, g in ref_grads.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["sgc", "gamlp", "sign"])
def test_link_models_through_the_zoo_match_flax(name):
    """``PrecomputeModel`` with a message op and a link head: the flax tree
    (with ``edge_fc``) carried across, the pairs' logits within 1e-5."""
    cfg = dict(model_name=name, hidden_dim=H, prop_steps=2, edge_mode="hadamard")
    spec = load_model(ModelConfig(**cfg), F, C, link=True)
    ref = ref_load_model(RefModelConfig(**cfg), F, C).module
    inputs = np.stack([X, ADJ @ X, ADJ @ ADJ @ X]).astype(np.float32)
    params = ref.init(jax.random.PRNGKey(1), jnp.asarray(inputs),
                      query_edges=jnp.asarray(PAIRS))["params"]
    spec.module.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    want = ref.apply({"params": params}, jnp.asarray(inputs), query_edges=jnp.asarray(PAIRS))
    with torch.no_grad():
        got = spec.module.eval()(torch.from_numpy(inputs), query_edges=torch.from_numpy(PAIRS))
    assert spec.link and got.shape == (PAIRS.shape[0], C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_link_heads_are_fixed_at_construction():
    """A link head needs ``query_edges`` and a node head refuses them;
    ``load_model(link=True)`` builds every registry model but the two whose
    heads score no pairs; a link spec is refused by ``NodeClassification``'s
    forward and a node spec by ``LinkClassification``."""
    x, q = torch.from_numpy(X), torch.from_numpy(PAIRS)
    with pytest.raises(ValueError, match="needs query_edges"):
        heads.LogisticRegression(F, C, link=True)(x)
    with pytest.raises(ValueError, match="takes no query_edges"):
        heads.MultiLayerPerceptron(F, H, C)(x, query_edges=q)
    with pytest.raises(ValueError, match="unknown edge feature mode"):
        heads.LogisticRegression(F, C, link=True, edge_mode="dot")
    for name in MODEL_REGISTRY:
        cfg = ModelConfig(model_name=name, hidden_dim=8)
        if name in ("magnet", "clean_train"):
            with pytest.raises(ValueError, match="no link head"):
                load_model(cfg, F, C, link=True)
        else:
            assert load_model(cfg, F, C, link=True).link and not load_model(cfg, F, C).link
    ds = synthetic_link_dataset(num_node=60, num_pairs=50, seed=0)
    mc = ModelConfig(model_name="sgc", prop_steps=2)
    with pytest.raises(ValueError, match="link=True"):
        LinkClassification(ds, load_model(mc, ds.num_features, 3), mc, TrainingConfig(),
                           device=CPU)


# --- augmentation -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def sparse_pair(base, tmp_path_factory):
    """The base graph sparsified at (0.5, 0.5) and loaded by each package."""
    ref_ds, _ = base
    root = tmp_path_factory.mktemp("sparse")
    ref_sparsify.sparsify_dataset(ref_ds, 0.5, 0.5, str(root / "sbm_aux"), seed=6)
    return (ref_load_sparsity("sbm_aux", str(root)),
            load_homo_simplex_sparsity_dataset("sbm_aux", str(root)))


@pytest.mark.parametrize("aux", [False, True], ids=["clean_ce", "l1_and_sparse_ce"])
def test_feature_augment_matches_with_carried_weights(sparse_pair, aux):
    """The reference's encoder initialization (its own key split) carried
    into the port's encoder, dropout 0: after 5 epochs the augmented
    features and soft labels within 1e-4."""
    ref_ds, ds = sparse_pair
    kw = dict(hidden_dim=32, epochs=5, lr=0.01, dropout=0.0)
    if aux:
        kw.update(l1_weight=0.1, sparse_ce_weight=0.1)
    seed = 1
    want_f, want_s = ref_augment.feature_augment(ref_ds, RefDataAugmentConfig(**kw), seed=seed)
    module = ref_heads.FeatureAugment2MLP(hidden_dim=32, output_dim=ds.num_classes, dropout=0.0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    params = module.init({"params": init_rng, "dropout": init_rng},
                         jnp.asarray(ref_ds.x[:2], jnp.float32), train=False)["params"]
    port = heads.FeatureAugment2MLP(ds.num_features, 32, ds.num_classes, dropout=0.0)
    port.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    got_f, got_s = augment.train_feature_encoder(port, ds, DataAugmentConfig(**kw), seed=seed,
                                                 device=CPU)
    assert got_f.shape == (ds.num_node, 32 + ds.num_classes) and np.isfinite(got_f).all()
    np.testing.assert_allclose(got_f, want_f, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.sum(1), 1.0, rtol=1e-4)


def test_feature_augment_auxiliary_losses_train(sparse_pair):
    _, ds = sparse_pair
    cfg = DataAugmentConfig(hidden_dim=32, epochs=30, lr=0.01, l1_weight=0.1,
                            sparse_ce_weight=0.1)
    feature, soft = augment.feature_augment(ds, cfg, seed=1, device=CPU)
    assert feature.shape == (ds.num_node, 32 + ds.num_classes) and np.isfinite(feature).all()
    np.testing.assert_allclose(soft.sum(1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("level", [1, 2])
def test_edge_augment_matches(sparse_pair, level):
    ref_ds, ds = sparse_pair
    feature = np.random.default_rng(0).normal(size=(ds.num_node, 8)).astype(np.float32)
    kw = dict(degree_level=level, candidates_per_deficit=50)
    ours = augment.edge_augment(ds, feature, DataAugmentConfig(**kw), seed=3)
    ref = ref_augment.edge_augment(ref_ds, feature, RefDataAugmentConfig(**kw), seed=3)
    np.testing.assert_array_equal(ours, ref)
    pairs = set(map(tuple, ours.T))
    assert all((b, a) in pairs for a, b in pairs)
    assert np.bincount(ours.reshape(-1), minlength=ds.num_node).min() >= level


def _roundtrip_best_test(pkg, ds, root):
    """Sparsify hard, augment, train SGC on the augmented graph (the JAX
    ``test_full_robustness_roundtrip``) with package ``pkg``."""
    kw = dict(hidden_dim=64, epochs=60, lr=0.01, degree_level=1, candidates_per_deficit=50)
    mk = dict(model_name="sgc", prop_steps=2)
    tk = dict(num_epochs=60, lr=0.01, seed=1)
    if pkg == "ref":
        ref_sparsify.sparsify_dataset(ds, 0.6, 0.6, os.path.join(root, "sbm_0.6_0.6"), seed=4)
        sp_ds = ref_load_sparsity("sbm_0.6_0.6", root)
        ref_augment.augment_dataset(sp_ds, RefDataAugmentConfig(**kw),
                                    os.path.join(root, "aug", "sbm_0.6_0.6"), seed=4)
        aug = ref_load_sparsity("sbm_0.6_0.6", os.path.join(root, "aug"), is_augumented=True)
        mc = RefModelConfig(**mk)
        return aug, RefNodeClassification(aug, ref_load_model(mc, aug.num_features,
                                                              aug.num_classes),
                                          mc, RefTrainingConfig(**tk)).best_test
    sparsify.sparsify_dataset(ds, 0.6, 0.6, os.path.join(root, "sbm_0.6_0.6"), seed=4)
    sp_ds = load_homo_simplex_sparsity_dataset("sbm_0.6_0.6", root)
    augment.augment_dataset(sp_ds, DataAugmentConfig(**kw), os.path.join(root, "aug", "sbm_0.6_0.6"),
                            seed=4, device=CPU)
    aug = load_homo_simplex_sparsity_dataset("sbm_0.6_0.6", os.path.join(root, "aug"),
                                             is_augumented=True)
    mc = ModelConfig(**mk)
    return aug, NodeClassification(aug, load_model(mc, aug.num_features, aug.num_classes), mc,
                                   TrainingConfig(**tk), device=CPU).best_test


def test_full_robustness_roundtrip_matches_reference(base, tmp_path):
    ref_ds, ds = base
    ref_aug, ref_best = _roundtrip_best_test("ref", ref_ds, str(tmp_path / "ref"))
    aug, best = _roundtrip_best_test("port", ds, str(tmp_path / "port"))
    assert aug.num_features == ref_aug.num_features == 64 + ds.num_classes
    assert best > 0.7, f"augmented acc {best:.3f}"
    assert abs(best - ref_best) <= 0.06, (best, ref_best)


def test_train_model_matches_reference():
    kw = dict(num_node=500, num_classes=3, num_features=24, seed=6)
    ref_ds, ds = ref_planetoid_like(**kw), planetoid_like(**kw)
    mk, tk = dict(model_name="clean_train", hidden_dim=32), dict(num_epochs=60, lr=0.01, seed=1)
    ref = RefTrainModel(ref_ds, ref_load_model(RefModelConfig(**mk), 24, 3), RefModelConfig(**mk),
                        RefTrainingConfig(**tk))
    tm = TrainModel(ds, load_model(ModelConfig(**mk), 24, 3), ModelConfig(**mk),
                    TrainingConfig(**tk), device=CPU)
    assert tm.best_test > 0.7 and abs(tm.best_test - ref.best_test) <= 0.06, (tm.best_test,
                                                                             ref.best_test)
    mid, logits = tm.get_mid_dim()
    assert mid.shape == (ds.num_node, 32) and logits.shape == (ds.num_node, 3)
    # the snapshot is the best epoch's: its validation accuracy is best_val
    val = np.asarray(ds.val_idx)
    assert abs(float((logits[val].argmax(1) == ds.y[val]).mean()) - tm.best_val) < 1e-6


# --- link datasets and link classification --------------------------------------------------


def _assert_link_datasets_equal(ours, ref):
    for field in ("x", "observed_edge_idx", "observed_edge_weight", "train_edge_pairs_idx",
                  "train_edge_pairs_label", "val_edge_pairs_idx", "val_edge_pairs_label",
                  "test_edge_pairs_idx", "test_edge_pairs_label"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field), err_msg=field)
    assert (ours.num_node, ours.num_classes, ours.num_features) == (
        ref.num_node, ref.num_classes, ref.num_features)


@pytest.mark.parametrize("label_mode", ["source_class", "same_community"])
def test_synthetic_link_dataset_matches(label_mode):
    kw = dict(num_node=300, num_pairs=400, seed=1, label_mode=label_mode)
    _assert_link_datasets_equal(synthetic_link_dataset(**kw), ref_synthetic_link_dataset(**kw))


def test_link_dataset_from_graph_matches(base):
    ref_ds, ds = base
    ours = link_dataset_from_graph(ds, val_frac=0.1, test_frac=0.2, seed=3)
    _assert_link_datasets_equal(ours, ref_link_dataset_from_graph(ref_ds, 0.1, 0.2, seed=3))
    full = ds.adj.tocoo()
    m = int((full.row < full.col).sum())
    assert ours.observed_edge_idx.shape[1] == 2 * (m - int(0.2 * m) - int(0.1 * m))
    neg = ours.test_edge_pairs_idx[ours.test_edge_pairs_label == 0]
    assert np.all(np.asarray(ds.adj.tocsr()[neg[:, 0], neg[:, 1]]).reshape(-1) == 0)
    sparse = Graph([0, 1, 2], [1, 2, 3], np.ones(3), 10, x=np.zeros((10, 2)))
    with pytest.raises(ValueError, match="too few"):
        link_dataset_from_graph(sparse)


LINK_RUNS = {  # name -> (dataset kwargs, model kwargs, training kwargs, band)
    "sgc": (dict(num_node=500, num_classes=3, num_features=32, num_pairs=600, seed=2),
            dict(model_name="sgc", prop_steps=2, hidden_dim=48, num_layers=2, dropout=0.3),
            dict(num_epochs=120, lr=0.01, seed=3), 0.75),
    "gamlp": (dict(num_node=500, num_classes=3, num_features=32, num_pairs=600, seed=2),
              dict(model_name="gamlp", prop_steps=2, hidden_dim=48, num_layers=2, dropout=0.3),
              dict(num_epochs=120, lr=0.01, seed=3), 0.75),
    "sgc_minibatch": (dict(num_node=400, num_pairs=500, seed=4),
                      dict(model_name="sgc", prop_steps=2),
                      dict(num_epochs=50, lr=0.01, seed=3, train_batch_size=128), 0.7),
    # the mean of three runs: the test split holds 80 pairs (0.0125 each),
    # and one run's best test moves by more than 0.06 between
    # initializations (0.925 in the port against 0.9875 in the reference at
    # seed 2023; over seeds 0-5 the means are 0.965 and 0.979)
    "sgc_scan_epochs": (dict(num_node=300, num_features=32, num_pairs=400, seed=1),
                        dict(model_name="sgc", prop_steps=2),
                        dict(num_epochs=60, lr=0.05, scan_epochs=True, normalize_times=3), 0.7),
}


@pytest.mark.parametrize("name", sorted(LINK_RUNS))
def test_link_classification_band_and_reference(name):
    dkw, mkw, tkw, band = LINK_RUNS[name]
    ref_ds = ref_synthetic_link_dataset(**dkw)
    ref = RefLinkClassification(ref_ds, ref_load_model(RefModelConfig(**mkw), ref_ds.num_features,
                                                       ref_ds.num_classes),
                                RefModelConfig(**mkw), RefTrainingConfig(**tkw))
    ds = synthetic_link_dataset(**dkw)
    mc = ModelConfig(**mkw)
    task = LinkClassification(ds, load_model(mc, ds.num_features, ds.num_classes, link=True), mc,
                              TrainingConfig(**tkw), device=CPU)
    assert task.best_test > band, f"{name} link acc {task.best_test:.3f}"
    assert abs(task.best_test - ref.best_test) <= 0.06, (task.best_test, ref.best_test)
    assert len(task.history["loss"]) == tkw["num_epochs"]
    assert max(task.history["val_acc"]) == task.record["val_acc"][-1]


def test_link_classification_from_a_graph_matches_reference(base):
    """Held-out edge detection on a from-graph split (the JAX
    ``test_link_classification_file_backed_end_to_end``): GAMLP with the
    ``hadamard`` pair features, and the port's adjacency is the observed
    graph's."""
    kw = dict(num_node=500, num_classes=4, num_features=24, seed=9)
    ref_link = ref_link_dataset_from_graph(ref_planetoid_like(**kw), seed=4)
    link = link_dataset_from_graph(planetoid_like(**kw), seed=4)
    mk = dict(model_name="gamlp", prop_steps=2, hidden_dim=64, edge_mode="hadamard")
    tk = dict(num_epochs=100, lr=0.01)
    ref = RefLinkClassification(ref_link, ref_load_model(RefModelConfig(**mk), 24, 2),
                                RefModelConfig(**mk), RefTrainingConfig(**tk))
    task = LinkClassification(link, load_model(ModelConfig(**mk), 24, 2, link=True),
                              ModelConfig(**mk), TrainingConfig(**tk), device=CPU)
    assert task.best_test > 0.6 and abs(task.best_test - ref.best_test) <= 0.06, (
        task.best_test, ref.best_test)
    obs = sp.csr_matrix((link.observed_edge_weight, tuple(link.observed_edge_idx)),
                        shape=(link.num_node, link.num_node))
    assert (link.adj != obs).nnz == 0


@pytest.mark.parametrize("name", ["gcn", "wavelet"])
def test_full_graph_link_heads_train_like_the_reference(name):
    """The GCN's and the wavelet model's link heads (the adjacency, or Φ and
    Φ⁻¹, in every forward) on the same split: best test within 0.06 of the
    reference's, and ``normalize_times`` runs each recorded."""
    kw = dict(num_node=300, num_classes=3, num_features=32, num_pairs=400, seed=1)
    mk = dict(model_name=name, prop_steps=2, hidden_dim=32)
    tk = dict(num_epochs=60, lr=0.01, normalize_times=2)
    ref_ds = ref_synthetic_link_dataset(**kw)
    ref = RefLinkClassification(ref_ds, ref_load_model(RefModelConfig(**mk), 32, 3),
                                RefModelConfig(**mk), RefTrainingConfig(**tk))
    ds = synthetic_link_dataset(**kw)
    task = LinkClassification(ds, load_model(ModelConfig(**mk), 32, 3, link=True),
                              ModelConfig(**mk), TrainingConfig(**tk), device=CPU)
    assert len(task.record["test_acc"]) == 2 and task.get_test_acc() == task.best_test
    assert abs(task.best_test - ref.best_test) <= 0.06, (task.best_test, ref.best_test)


def test_entry_points_default_to_cuda(sparse_pair, no_cuda, tmp_path):
    _, ds = sparse_pair
    cfg = DataAugmentConfig(hidden_dim=8, epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        augment.feature_augment(ds, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        augment.augment_dataset(ds, cfg, str(tmp_path / "aug"))
    mc = ModelConfig(model_name="clean_train", hidden_dim=8)
    with pytest.raises(RuntimeError, match="cuda"):
        TrainModel(ds, load_model(mc, ds.num_features, ds.num_classes), mc, TrainingConfig())
    link = synthetic_link_dataset(num_node=60, num_pairs=50, seed=0)
    mc = ModelConfig(model_name="sgc")
    with pytest.raises(RuntimeError, match="cuda"):
        LinkClassification(link, load_model(mc, link.num_features, 3, link=True), mc,
                           TrainingConfig())
