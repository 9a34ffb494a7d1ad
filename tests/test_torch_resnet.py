"""The port's ResNet (deeplearning_cfn_tpu_torch.models.resnet) against the
JAX package's Flax ResNet, on the CPU.

Tiny ResNets (``num_filters`` 8, one block per stage) with every block type
and stem — the classic 7×7/s2 ``conv7``, the space-to-depth ``s2d`` and the
CIFAR 3×3 stem — are initialised by Flax and bridged with
``params_from_flax``; the same numpy-seeded images go through both:

- train-mode logits and the updated ``batch_stats``, then eval-mode logits
  from those stats: f32 within 1e-5 relative to the largest value, bf16
  within 5e-2 of it (bf16 convs and BatchNorm outputs rounded to bf16 in
  both packages, in another order; see ``DTYPES``);
- gradients of every parameter against ``jax.grad``, within 2e-4 of each
  gradient's norm (see ``GRAD_TOL``; the zero-initialised head and last BN scales are
  replaced by random values first, so no gradient is trivially 0);
- the even image sizes (16, 32) make Flax's asymmetric SAME padding matter
  (the 7×7/s2 stem on 32 pads 2 / 3, the max-pool and the 3×3/s2 convs
  0 / 1),
  and a symmetric pad is shown to give other numbers;
- ``space_to_depth`` exact, ``BatchNorm``'s stored variance the biased one;
- a committed JAX ResNet checkpoint read by ``load_flax_checkpoint``;
- the full-width ResNet-50's parameter count, on the ``meta`` device
  against ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.models import resnet as jres
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models import build_model
from deeplearning_cfn_tpu_torch.models import resnet as tres

CONFIGS = {
    # name: (block, stem, image size)
    "bottleneck_conv7": ("bottleneck", "conv7", 32),
    "bottleneck_s2d": ("bottleneck", "s2d", 32),
    "basic_cifar": ("basic", "cifar", 16),
    "basic_conv7": ("basic", "conv7", 32),
}
# Logits within this much of the largest logit. bf16: at these sizes each
# package's bf16 logits are 0.5–9% of the largest logit away from its own
# f32 logits (bf16 convs and BN outputs rounded in another order), so the
# two packages' bf16 logits are compared at 5e-2.
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
# Gradients: within 2e-4 of each gradient's norm. This network's f32
# gradients are rounding-limited (BatchNorm's backward subtracts batch
# means): measured against an f64 evaluation of the same graph at these
# sizes, the port's f32 gradients are within 2.8e-5 of their norms and the
# JAX package's (jitted, XLA on the CPU) within 1.2e-4, so the packages
# cannot agree to 1e-5.
GRAD_TOL = 2e-4


def _models(config, dtype_name, num_classes=10):
    block, stem, size = CONFIGS[config]
    jdt, tdt, _ = DTYPES[dtype_name]
    kw = dict(stage_sizes=[1, 1, 1, 1], num_classes=num_classes,
              num_filters=8)
    jblock = jres.BottleneckBlock if block == "bottleneck" \
        else jres.BasicBlock
    tblock = tres.BottleneckBlock if block == "bottleneck" \
        else tres.BasicBlock
    stem_kw = dict(cifar_stem=True) if stem == "cifar" else dict(stem=stem)
    jm = jres.ResNet(block_cls=jblock, dtype=jdt, **kw, **stem_kw)
    tm = tres.ResNet(block_cls=tblock, dtype=tdt, **kw, **stem_kw)
    return jm, tm, size


def _init(jm, seed, x):
    """Flax variables of ``jm``. Params and stats are f32 whatever the
    compute dtype, so the (much faster on the CPU) f32 twin inits them."""
    return jm.clone(dtype=jnp.float32).init(jax.random.PRNGKey(seed), x[:1],
                                            train=False)


def _flat(tree, prefix=""):
    return {prefix + n: np.asarray(v) for n, v in flatten_with_names(tree)[0]}


def _randomize(variables, seed):
    """Random head, BN scales/biases and running stats, so no gradient is
    trivially 0 and eval reads stats other than 0 / 1."""
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        x = np.asarray(x)
        if name.startswith("params/head") or name.endswith(("scale",
                                                            "bias")):
            return jnp.asarray(rng.normal(0, 0.5, x.shape), x.dtype)
        if name.endswith("/mean"):
            return jnp.asarray(rng.normal(0, 0.3, x.shape), x.dtype)
        if name.endswith("/var"):
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), x.dtype)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(fill, variables)


def _bridge(tm, variables):
    tm.load_state_dict(params_from_flax(
        _flat(variables["params"]),
        batch_stats=_flat(variables["batch_stats"])), strict=True)


def _images(seed, n, size):
    return np.random.RandomState(seed).normal(
        0, 1, (n, size, size, 3)).astype(np.float32)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max error {err:.3e} of the largest value"


# (config, dtype) of the logits test: every block and stem in f32; in bf16
# the ResNet-50 block and stem and the CIFAR one.
CASES = [(c, "float32") for c in sorted(CONFIGS)] + [
    ("bottleneck_conv7", "bfloat16"), ("basic_cifar", "bfloat16")]
_JAX_CACHE = {}


def _jax_side(config, dtype_name):
    """One jitted JAX evaluation per case, shared by the tests: the
    variables, train-mode logits, updated batch stats, eval-mode logits
    from those stats and (f32) the gradients of ``sum(logits * w)``."""
    key = (config, dtype_name)
    if key not in _JAX_CACHE:
        jm, _, size = _models(config, dtype_name)
        x = _images(1, 4, size)
        w = np.random.RandomState(5).normal(0, 1, (4, 10)).astype(np.float32)
        variables = _randomize(_init(jm, 0, x), 3)

        def train_loss(params, stats):
            out, mutated = jm.apply({"params": params, "batch_stats": stats},
                                    x, train=True, mutable=["batch_stats"])
            return jnp.sum(out * w), (out, mutated["batch_stats"])

        @jax.jit
        def run(v):
            if dtype_name == "float32":
                (_, (logits, stats)), grads = jax.value_and_grad(
                    train_loss, has_aux=True)(v["params"], v["batch_stats"])
            else:
                _, (logits, stats) = train_loss(v["params"],
                                                v["batch_stats"])
                grads = None
            ev = jm.apply({"params": v["params"], "batch_stats": stats}, x,
                          train=False)
            return logits, stats, ev, grads

        _JAX_CACHE[key] = (x, w, variables, jax.device_get(run(variables)))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("config,dtype_name", CASES)
def test_logits_and_batch_stats_match_flax(config, dtype_name):
    _, tm, _ = _models(config, dtype_name)
    tol = DTYPES[dtype_name][2]
    x, _, variables, (logits, stats, want_eval, _) = _jax_side(
        config, dtype_name)
    _bridge(tm, variables)

    got = tm(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), logits, tol, "train logits")
    bridged = params_from_flax({}, batch_stats=_flat(stats))
    state = tm.state_dict()
    assert len(bridged) == 2 * sum(isinstance(m, tres.BatchNorm)
                                   for m in tm.modules())
    for key, want in bridged.items():
        # Stats are f32 in both packages: within f32 rounding of the
        # activations they are computed from.
        _close(state[key].numpy(), want.numpy(),
               1e-5 if dtype_name == "float32" else 1e-2, key)

    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x), train=False)
    _close(got_eval.numpy(), want_eval, tol, "eval logits")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_gradients_match_jax_grad(config):
    _, tm, _ = _models(config, "float32")
    x, w, variables, (*_, grads_jax) = _jax_side(config, "float32")
    _bridge(tm, variables)
    want = params_from_flax(_flat(grads_jax))
    out = tm(torch.from_numpy(x), train=True)
    (out * torch.from_numpy(w)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert grads.keys() == want.keys()
    for name, g in want.items():
        norm = g.norm().item()
        assert norm > 0, name
        err = (grads[name] - g).norm().item() / norm
        assert err <= GRAD_TOL, f"{name}: gradient differs by {err:.2e} " \
                                f"of its norm"


def test_loads_a_jax_resnet_checkpoint(tmp_path):
    """A committed JAX checkpoint of a ResNet (params and batch_stats) read
    with numpy only gives the same eval logits."""
    from deeplearning_cfn_tpu.ckpt.checkpoint import save_checkpoint
    from deeplearning_cfn_tpu_torch.convert import load_flax_checkpoint

    x, _, variables, (_, stats, want_eval, _) = _jax_side("bottleneck_s2d",
                                                          "float32")
    save_checkpoint(str(tmp_path), 3, {
        "step": jnp.asarray(3), "params": variables["params"],
        "batch_stats": stats})
    flat, step = load_flax_checkpoint(str(tmp_path))
    assert step == 3
    assert any(k.startswith("batch_stats/") for k in flat)
    _, tm, _ = _models("bottleneck_s2d", "float32")
    tm.load_state_dict(params_from_flax(flat), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    _close(got.numpy(), want_eval, 1e-5, "eval logits")


def test_same_padding_is_flax_asymmetric_rule():
    assert tres.same_pads(224, 7, 2) == (2, 3)   # the ResNet-50 stem
    assert tres.same_pads(112, 3, 2) == (0, 1)   # the max-pool
    assert tres.same_pads(56, 3, 2) == (0, 1)    # a 3×3/s2 conv
    assert tres.same_pads(112, 4, 1) == (1, 2)   # the s2d stem
    assert tres.same_pads(56, 3, 1) == (1, 1)
    assert tres.same_pads(56, 1, 2) == (0, 0)
    # Symmetric padding gives the same output size at another offset: the
    # numbers differ, so a shape check alone would not catch it.
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(0, 1, (1, 3, 64, 64)).astype(np.float32))
    conv = tres.Conv(3, 4, 7, 2, torch.float32)
    torch.nn.init.normal_(conv.weight)
    flax_like = conv(x)
    sym = torch.nn.functional.conv2d(x, conv.weight, stride=2, padding=3)
    assert flax_like.shape == sym.shape == (1, 4, 32, 32)
    assert not torch.allclose(flax_like, sym, atol=1e-3)


def test_space_to_depth_is_exact():
    x = np.arange(2 * 8 * 6 * 3, dtype=np.float32).reshape(2, 8, 6, 3)
    want = np.asarray(jres.space_to_depth(jnp.asarray(x), 2))
    got = tres.space_to_depth(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    # channel (bh·2 + bw)·C + c of output pixel (i, j) is input pixel
    # (2i + bh, 2j + bw), channel c.
    assert got[1, 2, 1, (1 * 2 + 0) * 3 + 2] == x[1, 5, 2, 2]


def test_batchnorm_stores_the_biased_variance():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (6, 5, 3, 3))
                         .astype(np.float32))
    bn = tres.BatchNorm(5, torch.float32)
    bn(x, train=True)
    flat = x.permute(1, 0, 2, 3).reshape(5, -1).double()
    biased = flat.var(dim=1, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * flat.mean(1)).numpy(), rtol=1e-5,
                               atol=1e-6)
    # Eval reads the running buffers, not the batch.
    before = bn.running_mean.clone()
    with torch.no_grad():
        y = bn(x, train=False)
    assert torch.equal(bn.running_mean, before)
    want = (x - bn.running_mean[None, :, None, None]) / torch.sqrt(
        bn.running_var[None, :, None, None] + 1e-5)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_seeded_init_follows_flax_distributions():
    tm = build_model("resnet50", 1000, torch.float32, num_filters=8)
    tres.init_weights(tm, torch.Generator().manual_seed(0))
    assert torch.count_nonzero(tm.head.weight) == 0
    for block in tm.blocks:
        assert torch.count_nonzero(block.norms[-1].weight) == 0
        assert torch.all(block.norms[0].weight == 1)
    w = tm.blocks[5].convs[1].weight  # 3×3, 16 → 16
    std = (2.0 / (3 * 3 * w.shape[0])) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.1
    again = build_model("resnet50", 1000, torch.float32, num_filters=8)
    tres.init_weights(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.blocks[5].convs[1].weight, w)


@pytest.mark.parametrize("name", ["resnet50", "resnet50_s2d", "resnet20"])
def test_full_width_parameter_count_matches_jax(name):
    size = 32 if name == "resnet20" else 224
    classes = 10 if name == "resnet20" else 1000
    jm = {"resnet50": jres.resnet50, "resnet50_s2d": jres.resnet50_s2d,
          "resnet20": jres.resnet20}[name](num_classes=classes)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, size, size, 3)), train=False))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    stats = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    tm = build_model(name, classes, torch.bfloat16, device="meta")
    assert sum(p.numel() for p in tm.parameters()) == want
    assert sum(b.numel() for b in tm.buffers()) == stats
    if name == "resnet50":
        assert want == 25_557_032
        # ~4.1 GMAC, the published 8.2 GFLOP per 224² image.
        assert 8.1e9 < tres.forward_flops(tm, 224) < 8.3e9
