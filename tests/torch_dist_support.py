"""Both packages' distributed layers on the same input: the JAX package's in
the pytest process (8 virtual CPU devices), the port's in the gloo world of
``torch_world`` (8 CPU ranks).  Imports JAX lazily, inside the helpers."""

from __future__ import annotations

import numpy as np

from torch_port_support import assert_close_c

_JMESH = {}


def jax_mesh(axes, dcn=None):
    from webgpufft_tpu.parallel import sharded
    key = (tuple(axes.items()), tuple((dcn or {}).items()))
    if key not in _JMESH:
        _JMESH[key] = sharded.make_mesh(dict(axes), dcn=dcn)
    return _JMESH[key]


def _sub(v, mesh):
    if isinstance(v, str) and v == "MESH":
        return mesh
    if isinstance(v, list):
        return [_sub(u, mesh) for u in v]
    return v


def _np(y):
    if isinstance(y, (tuple, list)):
        return type(y)(_np(v) for v in y)
    return np.asarray(y)


def jax_build(builder, bargs, bkw, axes, inputs=(), jit=True):
    """The JAX builder on ``inputs``: (output, extras, fn)."""
    import jax
    from webgpufft_tpu.parallel import nufft as JN
    from webgpufft_tpu.parallel import sharded as JS
    mesh = jax_mesh(axes)
    b = getattr(JS, builder, None) or getattr(JN, builder)
    res = b(*_sub(list(bargs), mesh), **{k: _sub(v, mesh) for k, v in bkw.items()})
    extra, fn = (), res
    if isinstance(res, tuple):
        extra, fn = tuple(np.asarray(e) for e in res[:-1]), res[-1]
    with mesh:
        out = _np((jax.jit(fn) if jit else fn)(*inputs))
    return out, extra, fn


# builders whose result is whole on every rank of the sequence axis by
# construction (a psum of per-rank partial sums), as in the JAX package
REPLICATED_BUILDERS = ("build_distributed_welch", "build_distributed_csd",
                       "build_distributed_nufft_type1")


def assert_stays_sharded(r, axes, what, replicated=False):
    """The call gathered no array (no all_gather of any kind ran in it) and,
    unless ``replicated``, its result is sharded on some mesh dim of more
    than one rank."""
    assert r["coll"]["all_gather"] == 0, (what, r["coll"])
    if replicated or max(axes.values()) == 1:
        return
    place = r["placements"]
    assert place is not None, (what, "not a DTensor")
    assert any(p.startswith("S") for n, p in place.items() if axes[n] > 1), \
        (what, place)


def both_build(world, builder, bargs, bkw, axes, inputs=(), tol=1e-5,
               attrs=("split",), jit=True):
    """Build and call one sharded builder in both packages; hold the port's
    output (shape and values, at ``tol`` of max|JAX|), extras and route
    attributes to the JAX package's, and check that it stayed sharded
    (``assert_stays_sharded``).  Returns (port, jax) outputs."""
    jout, jextra, jfn = jax_build(builder, bargs, bkw, axes, inputs, jit)
    r = world.run("build", builder, bargs, bkw, axes, list(inputs), list(attrs))
    assert_close_c(r["out"], jout, tol, builder)
    assert_stays_sharded(r, axes, builder, builder in REPLICATED_BUILDERS)
    for a, b in zip(r["extra"], jextra):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for a in attrs:
        got = r["attrs"][a]
        want = getattr(jfn, a, None)
        assert _norm(got) == _norm(want), (a, got, want)
    return r["out"], jout


def _norm(v):
    if isinstance(v, (tuple, list)):
        return tuple(_norm(u) for u in v)
    return v


def jax_plan(opts, axes, batch_axis=None, seq_axis=None):
    from webgpufft_tpu.parallel.plans import create_distributed_plan
    return create_distributed_plan(dict(opts), mesh=jax_mesh(axes),
                                   batch_axis=batch_axis, seq_axis=seq_axis)


def same_route(route, jplan):
    """mode, axis kinds and reasons equal; impl is the port's own."""
    jr = jplan.route
    assert route["mode"] == jr.mode, (route["mode"], jr.mode)
    assert tuple(route["reasons"]) == tuple(jr.reasons), (route["reasons"], jr.reasons)
    assert tuple(route["axis_kinds"]) == tuple(jr.axis_kinds)
    assert route["impl"] == "torch+gloo"


def both_plan(world, opts, axes, batch_axis=None, seq_axis=None, inputs=(),
              kernel=None, tol=1e-5, chain=None, call=True, flat_out=False):
    """create_distributed_plan in both packages from one options dict, run
    on the same input (``chain``: a second plan fed the first's output);
    routes equal, outputs within ``tol``, and the exec stayed sharded
    (``assert_stays_sharded``; ``flat_out``: the result is a flat strided
    buffer, which every rank holds whole).  Returns (port result dict, JAX
    output, JAX plan)."""
    jplan = jax_plan(opts, axes, batch_axis, seq_axis)
    jy = None
    if call:
        kw = {"kernel": kernel} if kernel is not None else {}
        with jax_mesh(axes):
            jy = jplan(*inputs, **kw)
            if chain is not None:
                jy = jax_plan(chain, axes, batch_axis, seq_axis)(jy)
        jy = np.asarray(jy)
    r = world.run("plan", opts, axes, batch_axis, seq_axis, list(inputs),
                  kernel, chain, call=call)
    same_route(r["route"], jplan)
    if call:
        assert_close_c(r["out"], jy, tol, str(opts.get("type")))
        if not flat_out:
            assert_stays_sharded(r, axes, str(opts))
    return r, jy, jplan


def cx(rng, *shape):
    """Seeded complex normal samples."""
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def il(z):
    """numpy complex -> interleaved float32."""
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def unil(y):
    y = np.asarray(y, np.float64)
    return y[..., 0] + 1j * y[..., 1]
