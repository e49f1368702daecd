"""pslite_tpu_torch's model-parallel helpers against the JAX package's.

The JAX side runs ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``; the port runs every rank at once on
``DeviceGroup(..., device="cpu")``, with the ranks as a leading
rank-major dim (``parallel/mesh.py``).  Inputs are numpy arrays made
from a seed; params are JAX's, carried across with
``convert.params_from_jax``.

Tolerances:
- the collectives and their gradients: exact (``array_equal``): they
  move values and add at most S of them, in the same order;
- ring attention, Ulysses, the MoE layer and the sharded forwards in
  float64: rtol/atol 1e-9 (``jax_enable_x64`` set and restored as in
  ``tests/test_model_parallel.py``): the two packages add in other
  orders, and exp/tanh/rsqrt differ in the last ulp;
- the same forwards in float32 with bfloat16 matmuls: JAX's own bars for
  its sharded forwards, rtol 5e-2 / atol 2e-2 (bfloat16 products
  accumulate in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from pslite_tpu.models import transformer as jt
from pslite_tpu.parallel import moe as jmoe
from pslite_tpu.parallel.mesh import make_mesh, shard_map_compat
from pslite_tpu.parallel.ring_attention import ring_attention as jring
from pslite_tpu.parallel.ring_attention import reference_attention as jref
from pslite_tpu.parallel.ulysses import ulysses_attention as julysses
from pslite_tpu_torch.convert import params_from_jax
from pslite_tpu_torch.models import transformer as tt
from pslite_tpu_torch.models.ps_step import tree_map
from pslite_tpu_torch.parallel import mesh as tm
from pslite_tpu_torch.parallel import moe as tmoe
from pslite_tpu_torch.parallel.ring_attention import ring_attention
from pslite_tpu_torch.parallel.ulysses import ulysses_attention

from torch_model_fixtures import (  # noqa: F401 - fixtures run by name
    _one_torch_thread, unshard, x64,
)


GRID = ((2, 4), ("dp", "sp"))
F64 = dict(rtol=1e-9, atol=1e-9)
BF16 = dict(rtol=5e-2, atol=2e-2)


def _group(shape=GRID[0], names=GRID[1]):
    return tm.make_group(shape, names, device="cpu")


def _per_rank_jax(fn, mesh, x):
    """``fn`` per device over blocks ``x[r]`` (rank-major over every mesh
    axis), results stacked back to ``[R, ...]``."""
    axes = tuple(mesh.axis_names)
    spec = P(axes)
    body = shard_map_compat(lambda b: fn(b[0])[None], mesh,
                            in_specs=(spec,), out_specs=spec)
    return jax.jit(body)(x)


COLLECTIVES = {
    # name: (JAX body on one rank's block, port op on [R, ...])
    "ppermute_dp": (
        lambda b: lax.ppermute(b, "dp", [(i, (i + 1) % 2) for i in range(2)]),
        lambda g, x: tm.ppermute(g, x, "dp")),
    "ppermute_sp": (
        lambda b: lax.ppermute(b, "sp", [(i, (i + 1) % 4) for i in range(4)]),
        lambda g, x: tm.ppermute(g, x, "sp")),
    "all_gather_sp_0": (
        lambda b: lax.all_gather(b, "sp", axis=0, tiled=True),
        lambda g, x: tm.all_gather(g, x, "sp", 0)),
    "all_gather_dp_1": (
        lambda b: lax.all_gather(b, "dp", axis=1, tiled=True),
        lambda g, x: tm.all_gather(g, x, "dp", 1)),
    "psum_scatter_sp_1": (
        lambda b: lax.psum_scatter(b, "sp", scatter_dimension=1, tiled=True),
        lambda g, x: tm.psum_scatter(g, x, "sp", 1)),
    "psum_scatter_dp_0": (
        lambda b: lax.psum_scatter(b, "dp", scatter_dimension=0, tiled=True),
        lambda g, x: tm.psum_scatter(g, x, "dp", 0)),
    "all_to_all_sp_1_0": (
        lambda b: lax.all_to_all(b, "sp", 1, 0, tiled=True),
        lambda g, x: tm.all_to_all(g, x, "sp", 1, 0)),
    "all_to_all_sp_0_2": (
        lambda b: lax.all_to_all(b, "sp", 0, 2, tiled=True),
        lambda g, x: tm.all_to_all(g, x, "sp", 0, 2)),
    "psum_dp": (lambda b: lax.psum(b, "dp"),
                lambda g, x: tm.psum(g, x, "dp")),
    "pmean_sp": (lambda b: lax.pmean(b, "sp"),
                 lambda g, x: tm.pmean(g, x, "sp")),
    "axis_index_sp": (
        lambda b: b + lax.axis_index("sp").astype(b.dtype),
        lambda g, x: x + tm.axis_index(g, "sp")[:, None, None, None].to(
            x.dtype)),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_and_its_transpose_match_shard_map(name):
    """Each collective on the rank dim equals ``shard_map``'s, value and
    gradient (autograd's transpose against ``jax.grad``'s)."""
    jfn, tfn = COLLECTIVES[name]
    mesh = make_mesh(*GRID)
    rng = np.random.default_rng(len(name))
    # Small integers: every sum is exact in float32, whatever its order.
    x = rng.integers(-8, 8, size=(8, 4, 8, 4)).astype(np.float32)
    w_shape = np.asarray(_per_rank_jax(jfn, mesh, jnp.asarray(x))).shape
    w = rng.integers(-4, 4, size=w_shape).astype(np.float32)

    def jloss(a):
        return jnp.sum(_per_rank_jax(jfn, mesh, a) * w)

    want = np.asarray(_per_rank_jax(jfn, mesh, jnp.asarray(x)))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    g = _group()
    xt = torch.tensor(x, requires_grad=True)
    out = tfn(g, xt)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)


def test_shard_unshard_match_partition_specs():
    """``shard`` cuts a global array as ``in_specs`` does (each rank's
    block), ``unshard`` reassembles it as ``out_specs``."""
    mesh = make_mesh(*GRID)
    g = _group()
    x = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    for spec in (("dp", "sp"), ("sp",), (None, "dp"), ("sp", "dp"), ()):
        body = shard_map_compat(lambda b: b[None], mesh,
                                in_specs=(P(*spec),),
                                out_specs=P(tuple(GRID[1])))
        want = np.asarray(body(jnp.asarray(x)))  # [R, *block]
        blocks = tm.shard(g, torch.tensor(x), spec)
        np.testing.assert_array_equal(blocks.numpy(), want)
        np.testing.assert_array_equal(unshard(g, blocks, spec).numpy(), x)


def _qkv(rng, B, T, H, D, dtype):
    return [rng.normal(size=(B, T, H, D)).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_attention_float64(x64, kind, causal):
    """Ring attention and Ulysses over an 8-rank ``sp`` axis against
    JAX's, and the single-rank reference attention against JAX's."""
    mesh = make_mesh((8,), ("sp",))
    g = tm.DeviceGroup(8, device="cpu", axis_name="sp")
    q, k, v = _qkv(np.random.default_rng(3), 2, 32, 8, 4, np.float64)
    jfn = jring if kind == "ring" else julysses
    spec = P(None, "sp")
    body = shard_map_compat(
        lambda a, b, c: jfn(a, b, c, "sp", causal=causal), mesh,
        in_specs=(spec, spec, spec), out_specs=spec)
    want = np.asarray(jax.jit(body)(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v)))
    tfn = ring_attention if kind == "ring" else ulysses_attention
    blocks = [tm.shard(g, torch.tensor(a), (None, "sp")) for a in (q, k, v)]
    got = unshard(g, tfn(g, *blocks, "sp", causal=causal), (None, "sp"))
    np.testing.assert_allclose(got.numpy(), want, **F64)
    ref = jax.jit(lambda a, b, c: jref(a, b, c, causal=causal))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tref = tt.reference_attention(*map(torch.tensor, (q, k, v)),
                                  causal=causal)
    np.testing.assert_allclose(tref.numpy(), np.asarray(ref), **F64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


def test_moe_layer_float64(x64):
    """The top-1 MoE layer, single rank and expert-parallel over ``sp``
    (8 experts, 2 per rank), against JAX's ``moe_ffn``."""
    params = jmoe.init_moe_params(jax.random.PRNGKey(5), 16, 32, 8,
                                  jnp.float64)
    x = np.random.default_rng(5).normal(size=(2, 8, 16))
    want = np.asarray(jax.jit(lambda p, a: jmoe.moe_ffn(p, a, None))(
        params, jnp.asarray(x)))
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    one = tree_map(lambda p: p[None], tp)
    got = tmoe.moe_ffn(one, torch.tensor(x)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, **F64)

    mesh = make_mesh((4,), ("sp",))
    g = tm.DeviceGroup(4, device="cpu", axis_name="sp")

    def local(p, xb):
        my = lax.axis_index("sp")
        lp = {"gate": p["gate"],
              "w_in": lax.dynamic_slice_in_dim(p["w_in"], my * 2, 2, 0),
              "w_out": lax.dynamic_slice_in_dim(p["w_out"], my * 2, 2, 0)}
        return jmoe.moe_ffn(lp, xb, "sp")

    body = shard_map_compat(local, mesh, in_specs=(P(), P(None, "sp")),
                            out_specs=P(None, "sp"))
    want = np.asarray(jax.jit(body)(params, jnp.asarray(x)))
    my = tm.axis_index(g, "sp")
    per = tree_map(lambda p: p[None].expand(4, *p.shape), tp)
    lp = {"gate": per["gate"],
          "w_in": per["w_in"].reshape(4, 4, 2, 16, 32)[torch.arange(4), my],
          "w_out": per["w_out"].reshape(4, 4, 2, 32, 16)[torch.arange(4),
                                                          my]}
    xb = tm.shard(g, torch.tensor(x), (None, "sp"))
    got = unshard(g, tmoe.moe_ffn(lp, xb, g, "sp"), (None, "sp"))
    np.testing.assert_allclose(got.numpy(), want, **F64)


def _jax_sharded_forward(params, tokens, cfg, mesh, strategy, moe):
    attn = jring if strategy == "ring" else julysses

    def local(p, tok_l):
        ctx = jt.ParallelCtx(
            attn_fn=lambda q, k, v: attn(q, k, v, "sp", causal=True),
            pos_offset=lax.axis_index("sp") * tok_l.shape[1],
            tp_axis=None if moe else "sp", ep_axis="sp" if moe else None)
        return jt.forward(p, tok_l, cfg, ctx=ctx)

    fn = shard_map_compat(local, mesh, in_specs=(P(), P("dp", "sp")),
                          out_specs=P("dp", "sp", None))
    return np.asarray(jax.jit(fn)(params, jnp.asarray(tokens)))


def _port_sharded_forward(params, tokens, cfg, strategy, moe):
    g = _group()
    attn = ring_attention if strategy == "ring" else ulysses_attention
    per = tree_map(lambda p: p[None].expand(8, *p.shape), params)
    tok = tm.shard(g, torch.tensor(tokens), ("dp", "sp"))
    ctx = tt.ParallelCtx(
        attn_fn=lambda q, k, v: attn(g, q, k, v, "sp", causal=True),
        pos_offset=tm.axis_index(g, "sp") * tok.shape[2],
        tp_axis=None if moe else "sp", ep_axis="sp" if moe else None,
        group=g)
    return unshard(g, tt.forward(per, tok, cfg, ctx=ctx),
                      ("dp", "sp")).numpy()


CASES = [("ring", False), ("ulysses", False), ("ring", True),
         ("ulysses", True)]


def _forward_case(strategy, moe, dtype):
    kw = dict(vocab=32, dim=32, heads=4, layers=2, dtype=dtype,
              moe_experts=8 if moe else 0)
    cfg, tcfg = jt.ModelConfig(**kw), tt.ModelConfig(**kw)
    params = jt.init_params(jax.random.PRNGKey(int(moe)), cfg)
    tokens = np.random.default_rng(int(moe)).integers(
        0, 32, size=(4, 4 * 4)).astype(np.int32)
    single = np.asarray(jax.jit(lambda p, t: jt.forward(p, t, cfg))(
        params, jnp.asarray(tokens)))
    want = _jax_sharded_forward(params, tokens, cfg, make_mesh(*GRID),
                                strategy, moe)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    got = _port_sharded_forward(tp, tokens, tcfg, strategy, moe)
    one = tt.forward(tp, torch.tensor(tokens), tcfg).numpy()
    return single, want, got, one


@pytest.mark.parametrize("strategy,moe", CASES,
                         ids=[f"{s}-{'moe' if m else 'tp'}" for s, m in CASES])
def test_sharded_forward_float64(x64, strategy, moe):
    """dp 2 x sp 4 with TP (or MoE EP) on the sp axis, ring or Ulysses:
    the port's sharded forward against JAX's and against the
    single-device forwards of both packages."""
    single, want, got, one = _forward_case(strategy, moe, "float64")
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(got, single, **F64)
    np.testing.assert_allclose(one, single, **F64)


@pytest.mark.parametrize("strategy,moe", CASES,
                         ids=[f"{s}-{'moe' if m else 'tp'}" for s, m in CASES])
def test_sharded_forward_float32_bf16(strategy, moe):
    """The same forwards in float32 with bfloat16 matmuls, at JAX's own
    bars for its sharded forwards."""
    single, want, got, one = _forward_case(strategy, moe, "float32")
    np.testing.assert_allclose(got, want, **BF16)
    np.testing.assert_allclose(got, single, **BF16)
    np.testing.assert_allclose(one, single, **BF16)
