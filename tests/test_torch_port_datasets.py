"""Parity of the port's configs, dataset loaders, data utilities and run
utilities with ``ssrg_tpu``, on the CPU.

The same inputs (seeded numpy arrays, raw files written to ``tmp_path``) go
through the reference and the port. Tolerances, each with its reason:

- configs: equal field for field;
- homophily statistics, edge-list utilities, spectral and surrogate
  features: 1e-12 (the same float64 numpy and scipy calls on the same
  arrays);
- loaders (Planetoid ``ind.*``, ``.npz`` bundles, the 8-file ``.pt``
  schema, reference pickles): arrays exactly equal;
- clustering metrics: 1e-12 of the reference's scikit-learn values (the
  port computes them in numpy, in another order).
"""

import dataclasses
import os
import os.path as osp
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu import utils as ref_utils
from ssrg_tpu.configs import config as ref_config
from ssrg_tpu.data import ogbn as ref_ogbn
from ssrg_tpu.data import planetoid as ref_planetoid
from ssrg_tpu.data import reference_compat as ref_compat
from ssrg_tpu.data import sparsity as ref_sparsity
from ssrg_tpu.data import utils as ref_data_utils
from ssrg_tpu.data.synthetic import planetoid_like as ref_planetoid_like
from ssrg_tpu.pipelines.sparsify import save_raw_dataset as ref_save_raw_dataset
from ssrg_tpu.train import base_task as ref_base_task
from ssrg_tpu.train import clustering_metrics as ref_metrics

import ssrg_torch
from ssrg_torch import utils
from ssrg_torch.configs import config
from ssrg_torch.data import ogbn, planetoid, reference_compat, sparsity
from ssrg_torch.data import utils as data_utils
from ssrg_torch.data.base_dataset import CACHE_SUFFIX
from ssrg_torch.data.graph import Graph
from ssrg_torch.train import base_task, clustering_metrics, visualize

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = 1e-12


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's tensors, which are small here: in a
    parallel run each worker shares the host's cores with the others, and
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_graphs_equal(ref, ours):
    """Two datasets (or graphs) hold equal arrays: features, labels, the
    stored edge list, the symmetric adjacency and the masks."""
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.y, ref.y)
    np.testing.assert_array_equal(ours.edge.row, ref.edge.row)
    np.testing.assert_array_equal(ours.edge.col, ref.edge.col)
    np.testing.assert_array_equal(ours.edge.edge_weight, ref.edge.edge_weight)
    assert ours.num_node == ref.num_node
    assert (ours.adj != ref.adj).nnz == 0
    for mask in ("feature_mask", "edge_mask"):
        a, b = getattr(ref, mask), getattr(ours, mask)
        assert (a is None) == (b is None), mask
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _assert_splits_equal(ref, ours):
    for split in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(ours, split)),
                                      np.asarray(getattr(ref, split)), err_msg=split)


# --- configs ------------------------------------------------------------------

CONFIGS = ("DataConfig", "DataProcessConfig", "DataAugmentConfig", "WaveletConfig",
           "ModelConfig", "TrainingConfig", "FrameworkConfig")


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_equal_the_reference(name):
    ref, ours = getattr(ref_config, name)(), getattr(config, name)()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_framework_config_replace_and_exports():
    cfg = config.FrameworkConfig().replace(model=config.ModelConfig(model_name="gcn"))
    assert cfg.model.model_name == "gcn" and cfg.data == config.DataConfig()
    assert ssrg_torch.DataConfig is config.DataConfig
    assert ssrg_torch.FrameworkConfig is config.FrameworkConfig


# --- data utilities -------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    """Edge lists with labels: an SBM and a random graph with self-loops
    and duplicate edges."""
    rng = np.random.default_rng(3)
    g = ref_planetoid_like(num_node=300, num_classes=4, num_features=8, seed=2)
    coo = g.adj.tocoo()
    row = rng.integers(0, 150, 900)
    col = rng.integers(0, 150, 900)
    return [(coo.row.astype(np.int64), coo.col.astype(np.int64), np.asarray(g.y), 300),
            (row, col, rng.integers(0, 5, 150), 150)]


def test_edge_list_utilities_match(graphs):
    for row, col, _, n in graphs:
        w = np.arange(row.size, dtype=np.float64)
        for a, b in zip(data_utils.remove_self_loops(row, col, w),
                        ref_data_utils.remove_self_loops(row, col, w)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(data_utils.to_undirected(row, col),
                        ref_data_utils.to_undirected(row, col)):
            np.testing.assert_array_equal(a, b)
        mat = sp.coo_matrix((w, (row, col)), shape=(n, n))
        for a, b in zip(data_utils.coomatrix_to_arrays(mat),
                        ref_data_utils.coomatrix_to_arrays(mat)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stat", ["edge_homophily", "node_homophily", "linkx_homophily"])
def test_homophily_statistics_match(graphs, stat):
    for row, col, y, n in graphs:
        args = (row, col, y) if stat == "edge_homophily" else (row, col, y, n)
        ours, ref = getattr(data_utils, stat)(*args), getattr(ref_data_utils, stat)(*args)
        assert abs(ours - ref) <= TOL and 0.0 <= ours <= 1.0
    empty = np.zeros(0, np.int64)
    assert data_utils.edge_homophily(empty, empty, np.zeros(3, np.int64)) == 0.0


def test_spectral_features_match(graphs):
    row, col, _, n = graphs[0]
    w = np.ones(row.size, np.float32)
    ours = data_utils.set_spectral_adjacency_reg_features(n, row, col, w, k=8)
    ref = ref_data_utils.set_spectral_adjacency_reg_features(n, row, col, w, k=8)
    assert ours.shape == (n, 8) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    tiny = data_utils.set_spectral_adjacency_reg_features(2, row[:0], col[:0], w[:0])
    assert tiny.shape == (2, 1) and not tiny.any()


def test_spectral_features_fall_back_only_when_arpack_does_not_converge(graphs, monkeypatch):
    """An ``ArpackNoConvergence`` gives the reference's seeded normal draws
    in both packages; any other failure raises in the port (the reference
    turns every exception into random features)."""
    import scipy.sparse.linalg as spla

    row, col, _, n = graphs[0]
    w = np.ones(row.size, np.float32)

    def no_convergence(*args, **kwargs):
        raise spla.ArpackNoConvergence("no convergence", np.zeros(0), np.zeros((n, 0)))

    monkeypatch.setattr(spla, "eigsh", no_convergence)
    ours = data_utils.set_spectral_adjacency_reg_features(n, row, col, w, k=4, seed=5)
    ref = ref_data_utils.set_spectral_adjacency_reg_features(n, row, col, w, k=4, seed=5)
    np.testing.assert_array_equal(ours, ref)

    def broken(*args, **kwargs):
        raise ValueError("broken solver")

    monkeypatch.setattr(spla, "eigsh", broken)
    with pytest.raises(ValueError, match="broken solver"):
        data_utils.set_spectral_adjacency_reg_features(n, row, col, w, k=4)
    assert ref_data_utils.set_spectral_adjacency_reg_features(n, row, col, w, k=4).shape == (n, 4)


class _Foreign:
    """A class outside what the port's unpickler admits."""


def test_pickle_io_round_trip_and_refusal(tmp_path):
    obj = {"a": np.arange(5), "r": range(2, 9), "m": sp.random(6, 6, 0.3, format="csr",
                                                              random_state=0),
           "g": Graph([0, 1], [1, 2], [1.0, 1.0], 3)}
    path = str(tmp_path / "obj.pkl")
    data_utils.pkl_write_file(obj, path)
    back = data_utils.pkl_read_file(path)
    np.testing.assert_array_equal(back["a"], obj["a"])
    assert back["r"] == obj["r"] and (back["m"] != obj["m"]).nnz == 0
    assert back["g"].num_node == 3
    np.testing.assert_array_equal(ref_data_utils.pkl_read_file(path)["a"], obj["a"])
    data_utils.pkl_write_file(_Foreign(), path)
    with pytest.raises(data_utils.ForeignPickleError, match="_Foreign"):
        data_utils.pkl_read_file(path)


def test_download_to_raises_on_an_unreachable_file_url(tmp_path):
    url = (tmp_path / "nowhere" / "missing.bin").as_uri()
    for fn in (data_utils.download_to, ref_data_utils.download_to):
        target = tmp_path / fn.__module__.split(".")[0] / "sub" / "x.bin"
        with pytest.raises(RuntimeError, match="no network egress"):
            fn(url, str(target))
        assert target.parent.is_dir() and not target.exists()


# --- Planetoid --------------------------------------------------------------------


def _make_fake_planetoid(raw_dir, name="cora", n_train=40, n_test=30, n_other=50, f=16, c=4,
                         gaps=0):
    """A consistent ``ind.*`` fixture; ``gaps`` test ids left out of the
    test range (citeseer's isolated test nodes)."""
    rng = np.random.default_rng(0)
    n_allx = n_train + n_other
    n = n_allx + n_test

    def onehot(k):
        out = np.zeros((k.shape[0], c))
        out[np.arange(k.shape[0]), k] = 1
        return out

    labels = rng.integers(0, c, n)
    test_ids = np.arange(n_allx, n)
    if gaps:
        test_ids = np.delete(test_ids, rng.choice(np.arange(1, n_test - 1), gaps, replace=False))
    allx = sp.csr_matrix(rng.uniform(size=(n_allx, f)) * (rng.uniform(size=(n_allx, f)) < 0.3))
    tx = sp.csr_matrix(rng.uniform(size=(test_ids.size, f))
                       * (rng.uniform(size=(test_ids.size, f)) < 0.3))
    graph = {i: rng.integers(0, n, 3).tolist() for i in range(n)}
    files = {
        f"ind.{name}.x": allx[:n_train],
        f"ind.{name}.y": onehot(labels[:n_train]),
        f"ind.{name}.tx": tx,
        f"ind.{name}.ty": onehot(labels[test_ids]),
        f"ind.{name}.allx": allx,
        f"ind.{name}.ally": onehot(labels[:n_allx]),
        f"ind.{name}.graph": graph,
    }
    os.makedirs(raw_dir, exist_ok=True)
    for fname, obj in files.items():
        with open(osp.join(raw_dir, fname), "wb") as fh:
            pickle.dump(obj, fh)
    with open(osp.join(raw_dir, f"ind.{name}.test.index"), "w") as fh:
        fh.write("\n".join(str(i) for i in rng.permutation(test_ids)))


@pytest.mark.parametrize("name,gaps", [("cora", 0), ("citeseer", 3)])
def test_planetoid_parser_matches(tmp_path, name, gaps):
    ref_root, root = tmp_path / "ref", tmp_path / "port"
    for r in (ref_root, root):
        _make_fake_planetoid(str(r / name / "raw"), name=name, gaps=gaps)
    ref = ref_planetoid.Planetoid(name, str(ref_root))
    ours = planetoid.Planetoid(name, str(root))
    _assert_graphs_equal(ref, ours)
    _assert_splits_equal(ref, ours)
    for stat in ("edge_homophily", "node_homophily", "linkx_homophily"):
        assert getattr(ours, stat) == getattr(ref, stat)
    assert ours.val_idx.shape[0] == 500 and ours.train_idx.shape[0] == 20 * ours.num_classes
    rowsum = np.abs(ours.x).sum(axis=1)
    np.testing.assert_allclose(rowsum[rowsum > 1e-6], 1.0, rtol=1e-4)
    np.testing.assert_allclose(planetoid.row_normalize(sp.csr_matrix(ours.x)).toarray(),
                               ref_planetoid.row_normalize(sp.csr_matrix(ours.x)).toarray())


def test_planetoid_cache_is_the_ports_own(tmp_path, monkeypatch):
    _make_fake_planetoid(str(tmp_path / "cora" / "raw"))
    first = planetoid.Planetoid("cora", str(tmp_path))
    cache = tmp_path / "cora" / "processed" / f"cora{CACHE_SUFFIX}"
    assert cache.exists() and not (tmp_path / "cora" / "processed" / "cora.graph").exists()

    def no_process(self):
        raise AssertionError("processed again instead of reading the cache")

    monkeypatch.setattr(planetoid.Planetoid, "process", no_process)
    _assert_graphs_equal(first, planetoid.Planetoid("cora", str(tmp_path)))
    with pytest.raises(ValueError):
        planetoid.Planetoid("unknown", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="egress"):
        planetoid.Planetoid("pubmed", str(tmp_path))


_TRAP = """
import sys
import numpy as np
from ssrg_torch.data.planetoid import Planetoid
ds = Planetoid("cora", sys.argv[1])
np.savez(sys.argv[2], x=ds.x, y=ds.y, row=ds.edge.row, col=ds.edge.col,
         test_idx=ds.test_idx)
try:
    Planetoid("cora", sys.argv[3])
except FileNotFoundError:
    pass
else:
    raise SystemExit("a root holding only the JAX package's cache loaded")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("ssrg_tpu", "jax", "flax", "optax"))
print("FOREIGN", bad)
"""


def test_a_root_processed_by_the_jax_package_loads_without_it(tmp_path):
    """The JAX package pickles its own ``Graph`` into ``<name>.graph``. In
    a fresh process the port loads such a root: it refuses that pickle
    without importing ``ssrg_tpu`` or jax, processes the raw files into its
    own cache and gives the JAX package's arrays; a root that holds only
    the JAX package's cache (no raw files) raises the missing-files error,
    again without importing either."""
    root, bare = tmp_path / "jax_root", tmp_path / "bare_root"
    _make_fake_planetoid(str(root / "cora" / "raw"))
    ref = ref_planetoid.Planetoid("cora", str(root))
    jax_cache = root / "cora" / "processed" / "cora.graph"
    assert jax_cache.exists()
    (bare / "cora" / "processed").mkdir(parents=True)
    (bare / "cora" / "processed" / "cora.graph").write_bytes(jax_cache.read_bytes())
    out = tmp_path / "arrays.npz"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _TRAP, str(root), str(out), str(bare)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FOREIGN []" in proc.stdout, proc.stdout
    got = np.load(out)
    for key, want in (("x", ref.x), ("y", ref.y), ("row", ref.edge.row), ("col", ref.edge.col),
                      ("test_idx", ref.test_idx)):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert (root / "cora" / "processed" / f"cora{CACHE_SUFFIX}").exists()
    with pytest.raises(data_utils.ForeignPickleError, match="ssrg_tpu"):
        data_utils.pkl_read_file(str(jax_cache))


# --- reference pickles ----------------------------------------------------------------


@pytest.fixture
def reference_pickle(tmp_path, monkeypatch):
    """A pickle of the reference's ``datasets.base_data`` Graph / Edge
    (and an unknown ``Node``) with numpy attributes, written through
    stand-in modules that are gone again once the test ends."""
    pkg = types.ModuleType("datasets")
    pkg.__path__ = []
    mod = types.ModuleType("datasets.base_data")
    for cls in ("Graph", "Edge", "Node"):
        setattr(mod, cls, type(cls, (), {"__module__": "datasets.base_data"}))
    monkeypatch.setitem(sys.modules, "datasets", pkg)
    monkeypatch.setitem(sys.modules, "datasets.base_data", mod)
    rng = np.random.default_rng(1)
    edge = mod.Edge()
    edge.row, edge.col = rng.integers(0, 40, 120), rng.integers(0, 40, 120)
    edge.edge_weight = np.ones(120, np.float32)
    graph = mod.Graph()
    graph.edge, graph.node = edge, mod.Node()
    graph.x = rng.normal(size=(40, 6)).astype(np.float32)
    graph.y = rng.integers(0, 3, 40)
    graph.num_node, graph.edge_type = 40, "UUU"
    graph.feature_mask = (rng.uniform(size=(40, 6)) > 0.5).astype(np.int64)
    path = tmp_path / "ref.graph"
    path.write_bytes(pickle.dumps(graph))
    return str(path)


def test_reference_pickles_load_in_both_packages(reference_pickle, tmp_path):
    ours = reference_compat.load_reference_processed(reference_pickle)
    ref = ref_compat.load_reference_processed(reference_pickle)
    assert isinstance(ours, Graph)
    _assert_graphs_equal(ref, ours)
    truncated = tmp_path / "cut.graph"
    truncated.write_bytes(open(reference_pickle, "rb").read()[:200])
    with pytest.raises(ValueError, match="not a complete pickle"):
        reference_compat.load_reference_processed(str(truncated))


def test_a_reference_processed_file_serves_a_dataset(reference_pickle, tmp_path, monkeypatch):
    """A ``<name>.graph`` the reference wrote loads through the shim when
    the port has no cache of its own."""
    _make_fake_planetoid(str(tmp_path / "cora" / "raw"))
    processed = tmp_path / "cora" / "processed"
    processed.mkdir()
    (processed / "cora.graph").write_bytes(open(reference_pickle, "rb").read())

    def no_process(self):
        raise AssertionError("processed the raw files instead of the reference's file")

    monkeypatch.setattr(planetoid.Planetoid, "process", no_process)
    ds = planetoid.Planetoid("cora", str(tmp_path))
    assert ds.num_node == 40 and ds.num_features == 6


def test_convert_reference_graph_and_surrogate_features_match(graphs):
    row, col, y, n = graphs[0]
    bag = reference_compat.ReferenceGraph()
    bag.__setstate__({"_row": row, "_col": col, "y": range(n), "adj": None})
    ours, ref = (reference_compat.convert_reference_graph(bag),
                 ref_compat.convert_reference_graph(bag))
    _assert_graphs_equal(ref, ours)
    with pytest.raises(ValueError, match="no edge list"):
        reference_compat.convert_reference_graph(reference_compat.ReferenceGraph())
    np.testing.assert_allclose(reference_compat.surrogate_node_features(n, row, col, k=6),
                               ref_compat.surrogate_node_features(n, row, col, k=6),
                               rtol=0, atol=TOL)


# --- the .pt schema -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """A raw directory written by the JAX package's ``save_raw_dataset``,
    its split indices then replaced by Python ``range`` objects (as the
    reference stores Planetoid splits)."""
    root = tmp_path_factory.mktemp("sparsity")
    g = ref_planetoid_like(num_node=200, num_classes=3, num_features=12, seed=4)
    coo = g.adj.tocoo()
    keep = coo.row < coo.col
    rng = np.random.default_rng(0)
    raw = ref_save_raw_dataset(
        str(root / "toy_0.5_0.5"), np.asarray(g.x), np.stack([coo.row[keep], coo.col[keep]]),
        np.asarray(g.y), np.asarray(g.train_idx), np.asarray(g.val_idx), np.asarray(g.test_idx),
        (rng.uniform(size=g.x.shape) > 0.5).astype(np.int64), np.arange(int(keep.sum())))
    torch.save(range(0, 30), osp.join(raw, "train_idx.pt"))
    torch.save(range(30, 80), osp.join(raw, "val_idx.pt"))
    return root


@pytest.mark.parametrize("augmented", [False, True])
def test_sparsity_dataset_matches(raw_root, tmp_path, augmented):
    roots = []
    for tag in ("ref", "port"):
        dst = tmp_path / tag / "toy_0.5_0.5" / "raw"
        dst.mkdir(parents=True)
        for f in os.listdir(raw_root / "toy_0.5_0.5" / "raw"):
            (dst / f).write_bytes((raw_root / "toy_0.5_0.5" / "raw" / f).read_bytes())
        roots.append(str(tmp_path / tag))
    ref = ref_sparsity.load_homo_simplex_sparsity_dataset("toy_0.5_0.5", roots[0],
                                                          is_augumented=augmented)
    ours = sparsity.load_homo_simplex_sparsity_dataset("toy_0.5_0.5", roots[1],
                                                       is_augumented=augmented)
    _assert_graphs_equal(ref, ours)
    _assert_splits_equal(ref, ours)
    np.testing.assert_array_equal(ours.train_idx, np.arange(30))
    np.testing.assert_array_equal(ours.sparse_x, ref.sparse_x)
    for stat in ("edge_homophily", "node_homophily", "linkx_homophily"):
        assert getattr(ours, stat) == getattr(ref, stat)
    assert ours.num_node_classes == ref.num_node_classes
    with pytest.raises(ValueError, match="official"):
        ours.generate_split("random")


def test_sparsity_dataset_surrogate_and_unreadable_features(raw_root, tmp_path):
    raw = raw_root / "toy_0.5_0.5" / "raw"
    for tag in ("ref", "port"):
        dst = tmp_path / tag / "toy" / "raw"
        dst.mkdir(parents=True)
        for f in os.listdir(raw):
            blob = (raw / f).read_bytes()
            (dst / f).write_bytes(blob[:100] if f == "feature.pt" else blob)
    ref = ref_sparsity.SparsityDataset("toy", str(tmp_path / "ref"), surrogate_features=True)
    ours = sparsity.SparsityDataset("toy", str(tmp_path / "port"), surrogate_features=True)
    _assert_graphs_equal(ref, ours)
    assert (tmp_path / "port" / "toy" / "processed" / f"toy.surrogate{CACHE_SUFFIX}").exists()
    with pytest.raises(ValueError, match="surrogate_features=True"):
        sparsity.SparsityDataset("toy", str(tmp_path / "port"))
    with pytest.raises(ValueError, match="surrogate_features=True"):
        ref_sparsity.SparsityDataset("toy", str(tmp_path / "ref"))
    with pytest.raises(FileNotFoundError, match="sparsify_dataset"):
        sparsity.SparsityDataset("absent", str(tmp_path / "port"))


# --- .npz bundles ----------------------------------------------------------------------------


def _write_npz(raw_dir, name, n=60, f=8, c=3, e=200, seed=0):
    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.savez(osp.join(raw_dir, f"{name}.npz"), x=rng.normal(size=(n, f)).astype(np.float32),
             y=rng.integers(0, c, n), edge_index=rng.integers(0, n, (2, e)),
             train_idx=np.arange(0, 30), val_idx=np.arange(30, 45), test_idx=np.arange(45, 60))


@pytest.mark.parametrize("name", ["arxiv", "products", "reddit", "flickr"])
def test_npz_loaders_match(tmp_path, name):
    for tag in ("ref", "port"):
        _write_npz(str(tmp_path / tag / name / "raw"), name, seed=len(name))
    ref = ref_ogbn.data_read(str(tmp_path / "ref"), name)
    ours = ogbn.data_read(str(tmp_path / "port"), name)
    assert type(ours).__name__ == type(ref).__name__
    _assert_graphs_equal(ref, ours)
    _assert_splits_equal(ref, ours)
    if name in ("reddit", "flickr"):
        again = getattr(ogbn, name.capitalize())(str(tmp_path / "port"))
        _assert_graphs_equal(ours, again)


def test_npz_loaders_refuse_what_is_missing(tmp_path):
    _make_fake_planetoid(str(tmp_path / "cora" / "raw"))
    assert isinstance(ogbn.data_read(str(tmp_path), "Cora"), planetoid.Planetoid)
    with pytest.raises(ValueError, match="not found"):
        ogbn.data_read(str(tmp_path), "unknown_ds")
    missing = osp.join(str(tmp_path), "products", "raw", "products.npz")
    with pytest.raises(FileNotFoundError, match="egress") as err:
        ogbn.Ogbn("products", str(tmp_path))
    assert missing in str(err.value)


# --- clustering metrics, plots, run utilities -------------------------------------------------


def _label_pairs():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 4, 200)
    return {
        "random": (y, rng.integers(0, 4, 200)),
        "permuted": (y, (y + 1) % 4),
        "noisy": (y, np.where(rng.uniform(size=200) < 0.2, rng.integers(0, 4, 200), y)),
        "more_clusters": (y, rng.integers(0, 6, 200)),
        "fewer_clusters": (y, y // 2),
        "one_cluster": (y, np.zeros(200, np.int64)),
        "both_one_cluster": (np.zeros(50, np.int64), np.full(50, 3)),
    }


@pytest.mark.parametrize("case", list(_label_pairs()))
def test_clustering_metrics_match_scikit_learn(case):
    true, pred = _label_pairs()[case]
    ours = clustering_metrics.evaluation_cluster_model_from_label(true, pred)
    ref = ref_metrics.evaluation_cluster_model_from_label(true, pred)
    assert set(ours) == set(ref) == {"acc", "f1_macro", "nmi", "ari"}
    for key in ref:
        assert abs(ours[key] - ref[key]) <= TOL, (key, ours[key], ref[key])


def test_plots_write_their_files(tmp_path):
    from threadpoolctl import threadpool_limits

    rng = np.random.default_rng(0)
    feats, labels = rng.normal(size=(80, 16)), rng.integers(0, 4, 80)
    # scikit-learn's t-SNE on one OpenMP thread: 80 points need no more, and
    # its spinning threads stall on a host whose cores the other workers hold
    with threadpool_limits(limits=1):
        coords = visualize.tsne_plot(feats, labels, str(tmp_path / "t.png"), perplexity=10)
        visualize.tsne_plot(feats, None, str(tmp_path / "u.png"), perplexity=10)
    assert coords.shape == (80, 2) and (tmp_path / "t.png").exists()
    visualize.loss_curve_plot([1.0, 0.5, 0.25], str(tmp_path / "l.png"))
    assert (tmp_path / "u.png").exists() and (tmp_path / "l.png").exists()


def test_run_utilities_match():
    pool = list(range(7))
    assert (utils.generate_numbers(12, 3, pool, np.random.default_rng(4))
            == ref_utils.generate_numbers(12, 3, pool, np.random.default_rng(4)))
    cand, target = np.random.default_rng(1).normal(size=(9, 5)), np.arange(5.0)
    np.testing.assert_allclose(utils.compute_distance(cand, target),
                               ref_utils.compute_distance(cand, target), rtol=0, atol=TOL)


def test_get_params_counts_what_the_reference_counts():
    import jax

    from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
    from ssrg_tpu.models.zoo import load_model as ref_load_model

    from ssrg_torch.models.zoo import load_model

    cfg = dict(model_name="gamlp", hidden_dim=16, prop_steps=2)
    module = load_model(config.ModelConfig(**cfg), 12, 3).module
    ref = ref_load_model(RefModelConfig(**cfg), 12, 3).module
    params = ref.init(jax.random.PRNGKey(0), np.zeros((3, 4, 12), np.float32))["params"]
    assert utils.get_params(module) == ref_utils.get_params(params)
    assert utils.get_params(module.state_dict().values()) == utils.get_params(module)


@pytest.mark.parametrize("method", ["execute", "evaluate", "train"])
def test_base_task_methods_are_abstract(method):
    for cls in (base_task.BaseTask, ref_base_task.BaseTask):
        with pytest.raises(NotImplementedError):
            getattr(cls(), method)()
