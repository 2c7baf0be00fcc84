"""Parity of the PyTorch port's training slice with ``ssrg_tpu``, on the CPU.

The same numpy inputs (``planetoid_like(800, 4, 48, seed=0)``) go through the
reference and the port; flax parameters are carried across with
``ssrg_torch.convert.params_from_jax``. Tolerances, each with its reason:

- optimizer steps: loss 1e-5 relative, parameters 1e-4 (Adam's update is
  the same algebra in another order, over five steps at lr 1e-3);
- BatchNorm: train-mode logits 1e-5, running statistics 1e-6;
- bf16 head: 2e-2 (operands rounded to bf16, 2^-8 relative, at other points
  in the two frameworks);
- heads against their flax twins: 1e-5; GCN loss and gradients: 1e-4;
- accuracy: the reference's bands, and the port's best test accuracy within
  0.06 of the reference's on the same configuration (different random
  initializations and dropout draws).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from flax import serialization

from ssrg_tpu import cache as ref_cache
from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
from ssrg_tpu.configs.config import TrainingConfig as RefTrainingConfig
from ssrg_tpu.data.synthetic import planetoid_like as ref_planetoid_like
from ssrg_tpu.models import heads as ref_heads
from ssrg_tpu.models.zoo import load_model as ref_load_model
from ssrg_tpu.ops.sparse import DenseAdj as RefDenseAdj
from ssrg_tpu.serve import Predictor as RefPredictor
from ssrg_tpu.train import common as ref_common
from ssrg_tpu.train.node_classification import NodeClassification as RefNodeClassification
from ssrg_tpu.train.node_classification import _make_step_fns
from ssrg_tpu.train.node_classification import prepare as ref_prepare

from ssrg_torch import _msgpack
from ssrg_torch import cache
from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.convert import params_from_jax, params_to_jax
from ssrg_torch.data.synthetic import planetoid_like
from ssrg_torch.models import heads
from ssrg_torch.models.zoo import load_model
from ssrg_torch.ops.ell_spmm import ell_spmm
from ssrg_torch.ops.normalize import sym_norm
from ssrg_torch.ops.sparse import DenseAdj, DifferentiableAdj, differentiable_adjacency
from ssrg_torch.serve import Predictor
from ssrg_torch.train import common
from ssrg_torch.train.node_classification import NodeClassification, prepare

CPU = "cpu"
NUM_FEATURES, NUM_CLASSES = 48, 4


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_node=800, num_classes=NUM_CLASSES, num_features=NUM_FEATURES, seed=0)
    return ref_planetoid_like(**kw), planetoid_like(**kw)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_close(state_dict, ref_tree, tol):
    ref = params_from_jax(_np_tree(ref_tree))
    assert set(ref) <= set(state_dict)
    for k, v in ref.items():
        np.testing.assert_allclose(state_dict[k].detach().numpy(), v.numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


# --- optimizer and BatchNorm parity ------------------------------------------


def _step_pair(datasets, model_cfg: dict, lr=1e-3, weight_decay=0.0, warmup=0):
    """The reference and the port set up on the same aggregated inputs with
    the same initial parameters: (ref train step, ref state, port state,
    inputs, labels, train ids). The rate is ``TrainingConfig``'s default:
    at 1e-2 the loss falls from 3.1 to 0.11 in five steps, and parameters
    equal within 1e-6 give losses 2e-5 apart (relative)."""
    ref_ds, ds = datasets
    ref_cfg = RefModelConfig(**model_cfg)
    ref_p = ref_prepare(ref_load_model(ref_cfg, NUM_FEATURES, NUM_CLASSES), ref_ds, ref_cfg,
                        RefTrainingConfig())
    inputs = np.asarray(ref_p.inputs)
    ref_state = ref_common.create_train_state(
        ref_p.module, jax.random.PRNGKey(0), inputs[:2], lr, weight_decay,
        warmup_epochs=warmup)
    has_bn = ref_state.batch_stats is not None
    ref_step = _make_step_fns(ref_p.module, None, has_bn)[0]
    cfg = ModelConfig(**model_cfg)
    module = prepare(load_model(cfg, NUM_FEATURES, NUM_CLASSES), ds, cfg, TrainingConfig(),
                     device=CPU).module
    variables = {"params": ref_state.params}
    if has_bn:
        variables["batch_stats"] = ref_state.batch_stats
    module.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    state = common.create_train_state(module, torch.Generator().manual_seed(0), lr,
                                      weight_decay, warmup)
    return ref_step, ref_state, state, inputs, np.asarray(ds.y), np.asarray(ds.train_idx)


def _batches(train_idx, batch_size, steps):
    """``steps`` minibatches over as many epochs as they take, from one
    numpy seed; the two packages' iterators give the same ones."""
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    out = []
    while len(out) < steps:
        ours = list(common.batch_iterator(train_idx, batch_size, rng))
        theirs = list(ref_common.batch_iterator(train_idx, batch_size, ref_rng))
        for (b, w), (rb, rw) in zip(ours, theirs):
            np.testing.assert_array_equal(b, rb)
            np.testing.assert_array_equal(w, rw)
        out += ours
    return out[:steps]


def _batch_list(train_idx, minibatch: bool, steps: int):
    if minibatch:
        return _batches(train_idx, 64, steps)
    return [(train_idx, None)] * steps


@pytest.mark.parametrize("minibatch", [False, True], ids=["full", "minibatch"])
@pytest.mark.parametrize("opt", [dict(), dict(weight_decay=5e-3, warmup=2)],
                         ids=["adam", "decay_warmup"])
def test_optimizer_steps_match_reference(datasets, minibatch, opt):
    model_cfg = dict(model_name="gbp", hidden_dim=32, num_layers=3, dropout=0.0)
    ref_step, ref_state, state, x, y, train_idx = _step_pair(datasets, model_cfg, **opt)
    init = {k: v.clone() for k, v in state.module.state_dict().items()}
    key = jax.random.PRNGKey(1)
    for step, (batch, w) in enumerate(_batch_list(train_idx, minibatch, 5), start=1):
        ref_state, ref_loss, _ = ref_step(ref_state, x[batch], y[batch],
                                          None if w is None else jnp.asarray(w), None, key)
        loss = common.train_step(state, torch.from_numpy(x[batch]), torch.from_numpy(y[batch]),
                                 None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        if step in (1, 5):
            _assert_state_close(state.module.state_dict(), ref_state.params, 1e-4)
        if step == 1 and opt.get("warmup"):
            # optax's linear warm-up reads its schedule at count 0: rate 0
            for k, v in state.module.state_dict().items():
                assert torch.equal(v, init[k]), k
    assert state.step == 5


def test_learning_rate_schedule():
    assert common.learning_rate(0, 0.1) == 0.1
    assert [common.learning_rate(s, 0.1, 4) for s in (0, 2, 4, 9)] == [0.0, 0.05, 0.1, 0.1]


def test_batchnorm_matches_flax(datasets):
    model_cfg = dict(model_name="gbp", hidden_dim=32, num_layers=3, dropout=0.0, use_bn=True)
    ref_step, ref_state, state, x, y, train_idx = _step_pair(datasets, model_cfg)
    module = state.module
    assert [n for n, _ in module.named_buffers()] == [
        "head.bn_0.running_mean", "head.bn_0.running_var",
        "head.bn_1.running_mean", "head.bn_1.running_var"]
    # train-mode logits at the initial parameters
    batch = x[train_idx]
    ref_logits, _ = ref_state.apply_fn(
        {"params": ref_state.params, "batch_stats": ref_state.batch_stats}, batch,
        train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        logits = module.train()(torch.from_numpy(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-5)
    module.load_state_dict(params_from_jax(_np_tree(
        {"params": ref_state.params, "batch_stats": ref_state.batch_stats})))
    # three minibatch steps, the padded last batch of the epoch included. A
    # Dense bias right before BatchNorm gets a gradient that is zero but for
    # rounding, which Adam scales up to steps of about lr: the two packages
    # move those biases apart (1e-3 after a step), and the running means
    # carry (1 - momentum) of each bias. So the running means are compared
    # less their own bias terms, sum_s (1 - m) m^(T-1-s) b_s, and the
    # running variances (which no bias moves) as they are.
    batches = _batches(train_idx, 64, 3)
    assert batches[1][1].min() == 0.0
    key = jax.random.PRNGKey(1)
    m = 0.99
    bias_terms = {i: [0.0, 0.0] for i in (0, 1)}  # (port, reference)
    for batch, w in batches:
        for i in (0, 1):
            pair = (module.state_dict()[f"head.fc_{i}.bias"].clone(),
                    torch.tensor(np.array(ref_state.params["head"][f"fc_{i}"]["bias"])))
            bias_terms[i] = [m * t + (1 - m) * b for t, b in zip(bias_terms[i], pair)]
        ref_state, ref_loss, _ = ref_step(ref_state, x[batch], y[batch], jnp.asarray(w), None, key)
        loss = common.train_step(state, torch.from_numpy(x[batch]), torch.from_numpy(y[batch]),
                                 torch.from_numpy(w))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    stats = params_from_jax({"params": {}, "batch_stats": _np_tree(ref_state.batch_stats)})
    for i in (0, 1):
        ours, theirs = bias_terms[i]
        np.testing.assert_allclose(
            (module.state_dict()[f"head.bn_{i}.running_mean"] - ours).numpy(),
            (stats[f"head.bn_{i}.running_mean"] - theirs).numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(module.state_dict()[f"head.bn_{i}.running_var"].numpy(),
                                   stats[f"head.bn_{i}.running_var"].numpy(), rtol=1e-6,
                                   atol=1e-6)
    # evaluation normalizes with the running statistics
    variables = {"params": ref_state.params, "batch_stats": ref_state.batch_stats}
    module.load_state_dict(params_from_jax(_np_tree(variables)))
    with torch.no_grad():
        got = module.eval()(torch.tensor(x[:50]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_state.apply_fn(variables, x[:50])),
                               rtol=1e-5, atol=1e-5)


def test_batchnorm_uses_the_biased_variance():
    bn = heads.BatchNorm(3).train()
    x = torch.tensor([[0.0, 1.0, 2.0], [2.0, 1.0, 0.0]])
    bn(x)
    # batch variance 1 (biased; torch.nn.BatchNorm1d would use 2)
    torch.testing.assert_close(bn.running_var, torch.tensor([1.0, 0.99, 1.0]))
    torch.testing.assert_close(bn.running_mean, torch.full((3,), 0.01))


def test_bf16_head_within_bf16_of_reference(datasets):
    x = np.random.default_rng(0).normal(size=(64, NUM_FEATURES)).astype(np.float32)
    ref = ref_heads.MultiLayerPerceptron(hidden_dim=32, output_dim=NUM_CLASSES, num_layers=3,
                                         dtype=jnp.bfloat16)
    variables = ref.init(jax.random.PRNGKey(0), x)
    want = np.asarray(ref.apply(variables, x))
    mlp = heads.MultiLayerPerceptron(NUM_FEATURES, 32, NUM_CLASSES, num_layers=3,
                                     dtype="bfloat16")
    mlp.load_state_dict(params_from_jax(_np_tree(variables)))
    with torch.no_grad():
        got = mlp.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and mlp.fc_0.weight.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


# --- the new heads against their flax twins ----------------------------------

K, N, F = 3, 37, 12
HOPS = np.random.default_rng(0).normal(size=(K + 1, N, F)).astype(np.float32)
ADJ = sp.random(N, N, density=0.2, format="csr", random_state=1, dtype=np.float32)


def _flax_and_port(ref_module, port_module, *args, **kwargs):
    variables = ref_module.init(jax.random.PRNGKey(1), *args, **kwargs)
    out = ref_module.apply(variables, *args, **kwargs)
    port_module.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    return variables, out


HEAD_CASES = {
    "resmlp": (lambda: ref_heads.ResMultiLayerPerceptron(hidden_dim=16, output_dim=5, num_layers=4),
               lambda: heads.ResMultiLayerPerceptron(F, 16, 5, num_layers=4), HOPS[0]),
    "resmlp_bn": (lambda: ref_heads.ResMultiLayerPerceptron(hidden_dim=16, output_dim=5,
                                                            num_layers=3, bn=True),
                  lambda: heads.ResMultiLayerPerceptron(F, 16, 5, num_layers=3, bn=True), HOPS[0]),
    "mlp_bn": (lambda: ref_heads.MultiLayerPerceptron(hidden_dim=16, output_dim=5, num_layers=3,
                                                      bn=True),
               lambda: heads.MultiLayerPerceptron(F, 16, 5, num_layers=3, bn=True), HOPS[0]),
    "identical": (ref_heads.IdenticalMapping, heads.IdenticalMapping, HOPS[0]),
    "one_dim_conv": (ref_heads.OneDimConvolution, lambda: heads.OneDimConvolution(K + 1), HOPS),
    "one_dim_conv_shared": (
        lambda: ref_heads.OneDimConvolutionWeightSharedAcrossFeatures(num_nodes=N),
        lambda: heads.OneDimConvolutionWeightSharedAcrossFeatures(N, K + 1), HOPS),
    "fast_one_dim_conv": (ref_heads.FastOneDimConvolution,
                          lambda: heads.FastOneDimConvolution(K + 1), HOPS.transpose(1, 0, 2)),
}


@pytest.mark.parametrize("name", sorted(HEAD_CASES))
def test_head_matches_flax(name):
    make_ref, make_port, x = HEAD_CASES[name]
    port = make_port()
    _, want = _flax_and_port(make_ref(), port, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(np.ascontiguousarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_layer2_gcn_head_matches_flax():
    port = heads.Layer2GraphConvolution(F, 16, 5)
    _, want = _flax_and_port(ref_heads.Layer2GraphConvolution(hidden_dim=16, output_dim=5), port,
                             HOPS[0], RefDenseAdj(jnp.asarray(ADJ.toarray())))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(HOPS[0]), DenseAdj(torch.from_numpy(ADJ.toarray())))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_feature_augment_mlp_and_clean_train_match_flax(datasets):
    port = heads.FeatureAugment2MLP(F, 16, 5)
    _, (h, logits) = _flax_and_port(ref_heads.FeatureAugment2MLP(hidden_dim=16, output_dim=5),
                                    port, HOPS[0])
    with torch.no_grad():
        got_h, got_logits = port.eval()(torch.from_numpy(HOPS[0]))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-5)
    # the zoo's clean_train: the featureless prepare hands the raw features
    ref_ds, ds = datasets
    cfg = ModelConfig(model_name="clean_train", hidden_dim=16)
    ref_cfg = RefModelConfig(model_name="clean_train", hidden_dim=16)
    spec = load_model(cfg, NUM_FEATURES, NUM_CLASSES)
    ref_spec = ref_load_model(ref_cfg, NUM_FEATURES, NUM_CLASSES)
    assert spec.graph_op is None and spec.prop_steps == 0 and not spec.naive
    p = prepare(spec, ds, cfg, TrainingConfig(), device=CPU)
    ref_p = ref_prepare(ref_spec, ref_ds, ref_cfg, RefTrainingConfig())
    np.testing.assert_array_equal(p.inputs.numpy(), np.asarray(ref_p.inputs))
    _, (h, logits) = _flax_and_port(ref_spec.module, spec.module, np.asarray(ref_p.inputs))
    with torch.no_grad():
        got_h, got_logits = spec.module.eval()(p.inputs)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("make", [
    lambda: (ref_heads.ResMultiLayerPerceptron(hidden_dim=256, output_dim=64, num_layers=3),
             heads.ResMultiLayerPerceptron(128, 256, 64, num_layers=3), "fc_0"),
    lambda: (ref_heads.Layer2GraphConvolution(hidden_dim=256, output_dim=64),
             heads.Layer2GraphConvolution(128, 256, 64), "fc1"),
    lambda: (ref_heads.FeatureAugment2MLP(hidden_dim=256, output_dim=64),
             heads.FeatureAugment2MLP(128, 256, 64), "fc1"),
], ids=["resmlp", "gcn", "feature_augment"])
def test_lecun_normal_init_matches_flax(make):
    """flax's default Dense init (lecun normal: a normal truncated at two
    standard deviations, variance 1/fan_in; zero bias), drawn from a
    ``torch.Generator``."""
    ref, port, name = make()
    x = np.zeros((4, 128), np.float32)
    args = (x, RefDenseAdj(jnp.eye(4))) if isinstance(ref, ref_heads.Layer2GraphConvolution) \
        else (x,)
    flax_w = np.asarray(ref.init(jax.random.PRNGKey(0), *args)["params"][name]["kernel"])
    port.reset_parameters(torch.Generator().manual_seed(0))
    w = getattr(port, name).weight.detach().numpy()
    assert not getattr(port, name).bias.detach().any()
    std = 1.0 / np.sqrt(128)
    for sample in (flax_w, w):
        assert abs(sample.std() / std - 1.0) < 0.05
        assert np.abs(sample).max() <= 2.0 * std / 0.87962566 * (1 + 1e-6)
    port2 = make()[1]
    port2.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(getattr(port2, name).weight, getattr(port, name).weight)


def test_dropout_draws_from_its_generator():
    drop = heads.Dropout(0.5).train()
    x = torch.ones(1000)
    with pytest.raises(RuntimeError, match="Generator"):
        drop(x)
    heads.bind_generator(drop, torch.Generator().manual_seed(3))
    a = drop(x)
    heads.bind_generator(drop, torch.Generator().manual_seed(3))
    assert torch.equal(a, drop(x))
    assert set(a.unique().tolist()) == {0.0, 2.0} and 400 < int((a == 0).sum()) < 600
    assert torch.equal(drop.eval()(x), x)


# --- the naive GCN's gradient --------------------------------------------------


@pytest.mark.parametrize("engine", ["dense", "hybrid"])
def test_gcn_step_gradients_match_jax_grad(datasets, engine):
    ref_ds, ds = datasets
    ref_cfg = RefModelConfig(model_name="gcn", hidden_dim=32, dropout=0.0)
    ref_p = ref_prepare(ref_load_model(ref_cfg, NUM_FEATURES, NUM_CLASSES), ref_ds, ref_cfg,
                        RefTrainingConfig(spmm_engine=engine))
    train_idx, y = np.asarray(ds.train_idx), np.asarray(ds.y)
    variables = ref_p.module.init(jax.random.PRNGKey(0), ref_p.inputs, adj=ref_p.adj_device)

    def loss_fn(params):
        logits = ref_p.module.apply({"params": params}, ref_p.inputs, adj=ref_p.adj_device)
        return ref_common.cross_entropy_loss(logits[train_idx], jnp.asarray(y[train_idx]))

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(variables["params"])
    cfg = ModelConfig(model_name="gcn", hidden_dim=32, dropout=0.0)
    p = prepare(load_model(cfg, NUM_FEATURES, NUM_CLASSES), ds, cfg,
                TrainingConfig(spmm_engine=engine), device=CPU)
    if engine == "hybrid":
        assert isinstance(p.adj_device, DifferentiableAdj) and p.adj_device.symmetric
    module = p.module
    module.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    logits = module.train()(p.inputs, p.adj_device)
    loss = common.cross_entropy_loss(logits[train_idx], torch.from_numpy(y[train_idx]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    grads = {k: v.grad for k, v in module.named_parameters()}
    for k, v in params_from_jax(_np_tree(ref_grads)).items():
        assert grads[k] is not None and bool(grads[k].abs().sum() > 0), k
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("engine", ["ell", "hybrid"])
def test_ell_function_gradient_is_the_transpose(engine):
    """Autograd through the ELL ``Function`` gives ``A^T g`` (float64 dense
    reference, 1e-5) on ``sym_norm(r=0.3)``, which is not symmetric: the
    backward runs on a pack of its own. A hub row gives the hybrid a tail."""
    g = planetoid_like(num_node=300, num_classes=3, num_features=8, seed=2)
    hub = sp.csr_matrix((np.ones(120), (np.zeros(120, int), np.arange(1, 121))),
                        shape=g.adj.shape)
    adj = sym_norm(((g.adj + hub + hub.T) > 0).astype(np.float32), 0.3)
    assert (adj != adj.T).nnz > 0
    dadj = differentiable_adjacency(adj, engine, device=CPU)
    assert isinstance(dadj, DifferentiableAdj) and not dadj.symmetric
    if engine == "hybrid":
        assert dadj.fwd.tail.nnz_padded > 0 and int((dadj.bwd.tail.val != 0).sum()) > 0
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(300, 20)).astype(np.float32), requires_grad=True)
    grad_out = rng.normal(size=(300, 20)).astype(np.float32)
    out = dadj.spmm(x)
    dense = adj.toarray().astype(np.float64)
    np.testing.assert_allclose(out.detach().numpy(), dense @ x.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    out.backward(torch.from_numpy(grad_out))
    np.testing.assert_allclose(x.grad.numpy(), dense.T @ grad_out, rtol=1e-5, atol=1e-5)
    # the symmetric sym_norm(r=0.5) reuses the forward pack
    sym = sym_norm(g.adj, 0.5)
    assert (sym != sym.T).nnz == 0
    assert differentiable_adjacency(sym, engine, device=CPU).symmetric


@pytest.mark.parametrize("engine", ["dense", "coo"])
def test_torch_engines_stay_plain_under_autograd(engine):
    adj = sym_norm(planetoid_like(num_node=100, num_classes=2, num_features=4, seed=1).adj, 0.3)
    dadj = differentiable_adjacency(adj, engine, device=CPU)
    assert not isinstance(dadj, DifferentiableAdj)
    x = torch.ones(100, 3, requires_grad=True)
    dadj.spmm(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy()[:, 0], np.asarray(adj.sum(axis=0)).ravel(),
                               rtol=1e-5)


def test_gcn_on_the_pallas_engine_raises_like_the_reference():
    """The reference's pallas engine cannot be differentiated (jax has no
    rule for its pallas_call); the port's raises a RuntimeError too."""
    kw = dict(num_node=120, num_classes=3, num_features=12, seed=3)
    ref_cfg = RefModelConfig(model_name="gcn", hidden_dim=8)
    with pytest.raises(Exception):
        RefNodeClassification(ref_planetoid_like(**kw), ref_load_model(ref_cfg, 12, 3), ref_cfg,
                              RefTrainingConfig(num_epochs=1, spmm_engine="pallas"))
    cfg = ModelConfig(model_name="gcn", hidden_dim=8)
    before = ell_spmm.launches
    with pytest.raises(RuntimeError, match="forward only"):
        NodeClassification(planetoid_like(**kw), load_model(cfg, 12, 3), cfg,
                           TrainingConfig(num_epochs=1, spmm_engine="pallas"), device=CPU)
    assert ell_spmm.launches == before


def test_meta_engines_degrade_to_auto_with_a_warning(datasets, caplog):
    _, ds = datasets
    cfg = ModelConfig(model_name="gcn", hidden_dim=8)
    with caplog.at_level(logging.WARNING, logger="ssrg_torch"):
        p = prepare(load_model(cfg, NUM_FEATURES, NUM_CLASSES), ds, cfg,
                    TrainingConfig(spmm_engine="reorder_tiled"), device=CPU)
    assert p.engine == "auto" and isinstance(p.adj_device, DenseAdj)
    assert any("reorder_tiled" in r.getMessage() and "naive" in r.getMessage()
               and "auto" in r.getMessage() for r in caplog.records)


# --- accuracy bands, as tests/test_end_to_end.py, against ssrg_tpu ------------

BANDS = {  # name: (model config, training config, band)
    "sgc": (dict(model_name="sgc"), dict(num_epochs=120), 0.75),
    "ssgc": (dict(model_name="ssgc"), dict(num_epochs=120), 0.75),
    "gbp": (dict(model_name="gbp"), dict(num_epochs=120), 0.75),
    "nafs": (dict(model_name="nafs"), dict(num_epochs=120), 0.75),
    "sign": (dict(model_name="sign", dropout=0.3), dict(num_epochs=120), 0.75),
    "gamlp": (dict(model_name="gamlp", dropout=0.3), dict(num_epochs=120), 0.75),
    "gcn": (dict(model_name="gcn", dropout=0.3), dict(num_epochs=150), 0.70),
    "sgc_scan": (dict(model_name="sgc"), dict(num_epochs=80, lr=0.05, scan_epochs=True), 0.85),
    "gamlp_scan": (dict(model_name="gamlp", dropout=0.5),
                   dict(num_epochs=80, scan_epochs=True), 0.85),
    "gcn_scan": (dict(model_name="gcn", dropout=0.5), dict(num_epochs=80, scan_epochs=True), 0.70),
}


@pytest.fixture(scope="module")
def reference_bands(datasets):
    """Each configuration of ``BANDS`` trained once by ``ssrg_tpu``."""
    ref_ds, _ = datasets
    out = {}
    for name, (mkw, tkw, _) in BANDS.items():
        mc = RefModelConfig(**{**dict(hidden_dim=64, prop_steps=3, num_layers=2), **mkw})
        tc = RefTrainingConfig(**{**dict(seed=7, lr=0.01), **tkw})
        out[name] = RefNodeClassification(ref_ds, ref_load_model(mc, NUM_FEATURES, NUM_CLASSES),
                                          mc, tc).best_test
    return out


@pytest.mark.parametrize("name", sorted(BANDS))
def test_accuracy_band_and_reference(datasets, reference_bands, name):
    _, ds = datasets
    mkw, tkw, band = BANDS[name]
    mc = ModelConfig(**{**dict(hidden_dim=64, prop_steps=3, num_layers=2), **mkw})
    tc = TrainingConfig(**{**dict(seed=7, lr=0.01), **tkw})
    task = NodeClassification(ds, load_model(mc, NUM_FEATURES, NUM_CLASSES), mc, tc, device=CPU)
    assert task.best_test > band, f"{name}: test acc {task.best_test:.3f}"
    assert abs(task.best_test - reference_bands[name]) <= 0.06, (task.best_test,
                                                                 reference_bands[name])
    assert len(task.history["loss"]) == tc.num_epochs
    assert max(task.history["val_acc"]) == task.best_val


# --- protocol -------------------------------------------------------------------


def _sgc_task(ds, **tkw):
    mc = ModelConfig(model_name="sgc", prop_steps=2)
    return NodeClassification(ds, load_model(mc, NUM_FEATURES, NUM_CLASSES), mc,
                              TrainingConfig(**{**dict(num_epochs=20, lr=0.01, seed=3), **tkw}),
                              device=CPU)


def test_batched_eval_matches_full_eval(datasets):
    _, ds = datasets
    full, batched = _sgc_task(ds), _sgc_task(ds, eval_batch_size=77)
    assert abs(full.best_val - batched.best_val) < 1e-6
    assert abs(full.best_test - batched.best_test) < 1e-6


def test_normalize_times_gives_one_record_a_run(datasets, capsys):
    _, ds = datasets
    mc = ModelConfig(model_name="sgc", prop_steps=2)
    task = NodeClassification(ds, load_model(mc, NUM_FEATURES, NUM_CLASSES), mc,
                              TrainingConfig(num_epochs=30, normalize_times=3, seed=7, lr=0.01),
                              verbose=True, device=CPU)
    assert len(task.record["test_acc"]) == 3 and np.std(task.record["test_acc"]) < 0.2
    assert task.best_test == pytest.approx(np.mean(task.record["test_acc"]))
    assert "Mean Val ± Std Val" in capsys.readouterr().out


def test_minibatch_training_learns(datasets):
    _, ds = datasets
    task = _sgc_task(ds, num_epochs=40, train_batch_size=64, seed=7)
    assert task.best_test > 0.7


def test_postprocess_matches_reference(datasets):
    ref_ds, ds = datasets
    ref_cfg = RefModelConfig(model_name="sgc", prop_steps=2)
    ref_task = RefNodeClassification(ref_ds, ref_load_model(ref_cfg, NUM_FEATURES, NUM_CLASSES),
                                     ref_cfg, RefTrainingConfig(), post_graph_op="sym", run=False)
    p = ref_task.prepared
    ref_state = ref_common.create_train_state(p.module, jax.random.PRNGKey(0),
                                              np.asarray(p.inputs)[:2], 0.01, 0.0)
    eval_step = _make_step_fns(p.module, None, False)[1]
    want = ref_task._postprocess(ref_state, eval_step)
    cfg = ModelConfig(model_name="sgc", prop_steps=2)
    task = NodeClassification(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg,
                              TrainingConfig(), post_graph_op="sym", run=False, device=CPU)
    module = task.prepared.module
    module.load_state_dict(params_from_jax(_np_tree(ref_state.params)))
    state = common.create_train_state(module, torch.Generator(), 0.01, 0.0)
    got = task._postprocess(state)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert _sgc_task(ds, num_epochs=40, seed=7).best_test > 0.7
    # the other single-adjacency post graph ops run; a tuple-valued one is refused
    ppr = NodeClassification(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg,
                             TrainingConfig(), post_graph_op="ppr", run=False, device=CPU)
    assert all(0.0 <= a <= 1.0 for a in ppr._postprocess(state))
    with pytest.raises(ValueError, match="tuple of adjacencies"):
        NodeClassification(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg,
                           TrainingConfig(), post_graph_op="magnetic", run=False, device=CPU)


# --- checkpoints -----------------------------------------------------------------


def _tree(rng):
    return {"head": {"fc_0": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                              "bias": np.zeros(3, np.float32)},
                     "prelu_0": {"slope": np.asarray(0.25, np.float32)},
                     "big": {"hop_node_weight": rng.normal(size=(3, 700, 1)).astype(np.float32)}},
            "msg_op": {"jk": {"kernel": rng.normal(size=(40, 1)).astype(np.float32)}}}


def test_msgpack_writes_and_reads_flax_bytes():
    tree = _tree(np.random.default_rng(0))
    data = _msgpack.packb(tree)
    assert data == serialization.to_bytes(tree)
    back = _msgpack.unpackb(serialization.to_bytes(tree))
    flax_back = serialization.msgpack_restore(data)
    for got in (back, flax_back):
        for path in (("head", "fc_0", "kernel"), ("head", "prelu_0", "slope"),
                     ("head", "big", "hop_node_weight"), ("msg_op", "jk", "kernel")):
            a, b = got, tree
            for key in path:
                a, b = a[key], b[key]
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    for obj in ([1, -1, 200, -200, 70000, -70000, 2**40, -(2**40)], "x" * 40, b"y" * 300,
                3.5, None, True, {"k" * 300: [1.5, "v"]}, np.float32(2.0)):
        assert _msgpack.unpackb(_msgpack.packb(obj)) == obj
    with pytest.raises(ValueError, match="chunk"):
        _msgpack.packb({"a": np.zeros(2 ** 28 + 1, np.float32)})


@pytest.mark.parametrize("bn", [False, True])
def test_checkpoints_cross_between_packages(tmp_path, bn):
    cfg = ModelConfig(model_name="gamlp", hidden_dim=16, use_bn=bn)
    ref_spec = ref_load_model(RefModelConfig(model_name="gamlp", hidden_dim=16, use_bn=bn),
                              F, 4)
    variables = _np_tree(ref_spec.module.init(jax.random.PRNGKey(0), HOPS))
    tree = variables if bn else variables["params"]
    path = str(tmp_path / "ref.ckpt")
    ref_cache.save_params(tree, path, metadata={"has_bn": bn})
    got = cache.load_params(path)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(a, b)
    assert cache.load_metadata(path) == {"has_bn": bn}
    # and back: the port's state dict, written by the port, read by the reference
    module = load_model(cfg, F, 4).module
    module.reset_parameters(torch.Generator().manual_seed(1))
    mine = str(tmp_path / "port.ckpt")
    out = params_to_jax(module.state_dict())
    cache.save_params(out if bn else out["params"], mine)
    restored = ref_cache.load_params(tree, mine)
    assert params_from_jax(_np_tree(restored)).keys() == module.state_dict().keys()
    for k, v in params_from_jax(_np_tree(restored)).items():
        assert torch.equal(v, module.state_dict()[k]), k


@pytest.mark.parametrize("name,bn", [("gamlp", False), ("gamlp", True), ("gcn", False)])
def test_predictor_serves_a_reference_checkpoint(datasets, tmp_path, name, bn):
    ref_ds, ds = datasets
    ckpt = str(tmp_path / "ref.ckpt")
    kw = dict(model_name=name, hidden_dim=32, num_layers=2, use_bn=bn)
    ref_cfg = RefModelConfig(**kw)
    RefNodeClassification(ref_ds, ref_load_model(ref_cfg, NUM_FEATURES, NUM_CLASSES), ref_cfg,
                          RefTrainingConfig(num_epochs=5, lr=0.05, checkpoint_path=ckpt))
    ref = RefPredictor(ref_ds, ref_load_model(ref_cfg, NUM_FEATURES, NUM_CLASSES), ref_cfg,
                       RefTrainingConfig(), checkpoint_path=ckpt)
    cfg = ModelConfig(**kw)
    got = Predictor(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg, TrainingConfig(),
                    checkpoint_path=ckpt, device=CPU)
    assert got.metadata["model"] == name and got.metadata["has_bn"] is bn
    ids = np.concatenate([ds.test_idx, [0, 799]])
    np.testing.assert_allclose(got.logits(ids).numpy(), ref.logits(ids), rtol=1e-4, atol=1e-4)


def test_reference_predictor_serves_a_port_checkpoint(datasets, tmp_path):
    ref_ds, ds = datasets
    ckpt = str(tmp_path / "port.ckpt")
    kw = dict(model_name="gamlp", hidden_dim=32, num_layers=2, use_bn=True)
    cfg = ModelConfig(**kw)
    task = NodeClassification(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg,
                              TrainingConfig(num_epochs=8, lr=0.05, checkpoint_path=ckpt),
                              device=CPU)
    meta = cache.load_metadata(ckpt)
    assert meta["has_bn"] is True and meta["val_acc"] == task.best_val
    ref_cfg = RefModelConfig(**kw)
    ref = RefPredictor(ref_ds, ref_load_model(ref_cfg, NUM_FEATURES, NUM_CLASSES), ref_cfg,
                       RefTrainingConfig(), checkpoint_path=ckpt)
    got = Predictor(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg, TrainingConfig(),
                    checkpoint_path=ckpt, device=CPU)
    ids = ds.val_idx
    np.testing.assert_allclose(got.logits(ids).numpy(), ref.logits(ids), rtol=1e-4, atol=1e-4)
    acc = float((got.predict(ids).numpy() == np.asarray(ds.y)[ids]).mean())
    assert abs(acc - meta["val_acc"]) <= 1e-6


def test_bn_model_refuses_a_params_only_checkpoint_and_resumes(datasets, tmp_path):
    _, ds = datasets
    cfg = ModelConfig(model_name="gamlp", hidden_dim=32, num_layers=2, use_bn=True)
    module = load_model(cfg, NUM_FEATURES, NUM_CLASSES).module
    legacy = str(tmp_path / "legacy.ckpt")
    cache.save_params(params_to_jax(module.state_dict())["params"], legacy,
                      metadata={"model": "gamlp"})
    with pytest.raises(ValueError, match="BatchNorm"):
        Predictor(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg, checkpoint_path=legacy,
                  device=CPU)
    # resume_from restores the parameters before the first epoch
    resumed = NodeClassification(ds, load_model(cfg, NUM_FEATURES, NUM_CLASSES), cfg,
                                 TrainingConfig(num_epochs=0, resume_from=legacy), device=CPU)
    for k, v in params_from_jax(cache.load_params(legacy)).items():
        assert torch.equal(resumed.state.module.state_dict()[k], v), k


def test_scan_epochs_checkpoints_the_best_params(datasets, tmp_path):
    """``scan_epochs`` runs the one epoch loop: the same history as without
    it. The checkpoint holds the first epoch of best val accuracy: the
    ``Predictor`` restoring it gives the logits of a run stopped at that
    epoch, not those of the last epoch."""
    _, ds = datasets
    ckpt = str(tmp_path / "best.ckpt")
    mc = ModelConfig(model_name="sgc", prop_steps=3)

    def run(**tkw):
        return NodeClassification(ds, load_model(mc, NUM_FEATURES, NUM_CLASSES), mc,
                                  TrainingConfig(**{**dict(num_epochs=40, lr=0.05), **tkw}),
                                  device=CPU)

    task = run(scan_epochs=True, checkpoint_path=ckpt)
    assert run().history == task.history
    meta = cache.load_metadata(ckpt)
    assert meta["val_acc"] == task.best_val and meta["has_bn"] is False
    best_epoch = int(np.argmax(task.history["val_acc"])) + 1
    assert meta["epoch"] == best_epoch < 40
    pred = Predictor(ds, load_model(mc, NUM_FEATURES, NUM_CLASSES), mc, checkpoint_path=ckpt,
                     device=CPU)
    served = pred.logits(ds.val_idx)
    stopped = run(num_epochs=best_epoch)
    np.testing.assert_allclose(served.numpy(), stopped.logits(stopped.state, ds.val_idx).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not torch.allclose(served, task.logits(task.state, ds.val_idx), atol=1e-4)
    acc = float((served.argmax(-1).numpy() == np.asarray(ds.y)[ds.val_idx]).mean())
    assert abs(acc - task.best_val) <= 1e-6


def test_training_entry_points_default_to_cuda(datasets, no_cuda, tmp_path):
    _, ds = datasets
    cfg = ModelConfig(model_name="gcn", hidden_dim=8)
    spec = load_model(cfg, NUM_FEATURES, NUM_CLASSES)
    with pytest.raises(RuntimeError, match="cuda"):
        NodeClassification(ds, spec, cfg, TrainingConfig(num_epochs=1))
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(ds, spec, cfg, checkpoint_path=str(tmp_path / "none.ckpt"))
