"""lushnerf_torch.convert: the weight bridge between the JAX params tree,
the port's LushNeRF state dict and reference `.tar` checkpoints."""

import numpy as np
import pytest

import jax

import __graft_entry__ as ge
from lushnerf_tpu.models.lushnerf import init_lush_params
from lushnerf_tpu.train.torch_import import params_to_torch_state, save_torch_checkpoint
from lushnerf_torch.config import flagship_cfg
from lushnerf_torch.convert import load_reference_checkpoint, params_from_jax, params_to_jax
from lushnerf_torch.models.lushnerf import LushNeRF


def params_like_init(init_fn, seed=0):
    """A params tree with the exact structure `init_fn(key)` gives (read by
    jax.eval_shape, which compiles nothing) and numpy leaves drawn at init
    scales: weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), biases U(-1/n, 1/n),
    N(0, 1) for the RBK embedding, 1e-3 for the RBK r/v head weights
    (near-identity warps, as the init's 1e-5 bound intends)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            v = rng.standard_normal(s.shape)
        else:
            k = 1.0 / (np.sqrt(s.shape[0]) if len(s.shape) == 2 else s.shape[0])
            if len(s.shape) == 2 and ("r_out" in name or "v_out" in name):
                k = 1e-3
            v = rng.uniform(-k, k, s.shape)
        leaves.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def jax_params(lush_cfg, seed=0):
    return params_like_init(lambda k: init_lush_params(k, lush_cfg), seed)


def _jax_params(tiny):
    return jax_params(ge._flagship_cfg(3, tiny=tiny).lush_config(), seed=3)


def _model(tiny):
    return LushNeRF(flagship_cfg(3, tiny=tiny).lush_config(), seed=1, device="cpu")


def _assert_tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "flagship"])
def test_jax_to_port_to_jax_is_exact(tiny):
    params = _jax_params(tiny)
    model = _model(tiny)
    model.load_state_dict(params_from_jax(params), strict=True)
    _assert_tree_equal(params_to_jax(model.state_dict()), params)


def test_state_dict_keys_match_reference_layout():
    params = _jax_params(tiny=True)
    ref_keys = set(params_to_torch_state(params, module_prefix=False))
    assert set(_model(tiny=True).state_dict()) == ref_keys


def test_reference_tar_loads_strict(tmp_path):
    params = _jax_params(tiny=True)
    path = tmp_path / "000123.tar"
    save_torch_checkpoint(path, 123, params)
    step, sd = load_reference_checkpoint(path)
    assert step == 123
    model = _model(tiny=True)
    model.load_state_dict(sd, strict=True)
    w = model.mlp_fine.pts_linears[1].weight.detach().numpy()
    np.testing.assert_array_equal(w, np.asarray(params["fine"]["pts"][1][0]).T)
    emb = model.blur_kernel_net.RBK.view_embedding_layer.view_embed_layer.weight
    assert emb is model.dbk_view_embedding.view_embed_layer.weight
    np.testing.assert_array_equal(emb.detach().numpy(), np.asarray(params["rbk"]["embed"]))
    np.testing.assert_array_equal(model.mlp_rbk.w_linear.bias.detach().numpy(),
                                  params["rbk"]["w_out"][1])
