"""``repro_torch.sharding.partition`` against the JAX package's partition
rules: parameter, optimizer, batch and cache specs for all ten configs at
their published sizes on the production meshes (16 × 16, 2 × 16 × 16) and a
4 × 2 mesh, built without a device (the JAX package's from an
``AbstractMesh``, the port's from a meta-device ``Mesh``); then the port's
own additions, ``local_shape`` and ``shard``/``unshard``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.sharding import partition as tpart  # noqa: E402

ARCHS = jcfgs.list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    if name == "16x16":
        port = make_production_mesh()
    elif name == "2x16x16":
        port = make_production_mesh(multi_pod=True)
    else:
        port = Mesh(["meta"] * 8, shape, axes)
    return AbstractMesh(shape, axes), port


def _jax_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in flat}


def _port_flat(tree, prefix="") -> dict:
    if isinstance(tree, tpart.PartitionSpec):
        return {prefix[:-1]: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}{k}/"))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    want = jpart.param_pspecs(jcfg, jtr.param_specs(jcfg), jmesh)
    specs = ttr.param_specs(tcfg)
    got = tpart.param_pspecs(tcfg, ttr.jax_layout(tcfg, specs), tmesh)
    assert _port_flat(got) == _jax_flat(want)
    assert _port_flat(tpart.opt_state_pspecs(got)) == _jax_flat(jpart.opt_state_pspecs(want))
    # the port's own layout: each layer's leaf takes the stacked spec without
    # its leading None
    own = _port_flat(tpart.param_pspecs(tcfg, specs, tmesh))
    stacked = _port_flat(got)
    kinds, at = [], 0
    for si, (unit, repeat) in enumerate(tcfg.segments):
        for r in range(repeat):
            for i in range(len(unit)):
                prefix = f"layers/{at}/"
                for key, spec in own.items():
                    if key.startswith(prefix):
                        assert (None,) + spec == stacked[f"seg{si}/l{i}/" + key[len(prefix):]]
                at += 1
        kinds += list(unit) * repeat
    for key, spec in own.items():
        if not key.startswith(("layers/", "encoder/")):
            assert spec == stacked[key]
        elif key.startswith("encoder/"):
            rest = key.split("/", 2)[2]
            assert (None,) + spec == stacked[f"encoder/l0/{rest}"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        jspecs = {k: v for k, v in jcfgs.input_specs(jcfg, shape).items()}
        tspecs = tcfgs.input_specs(tcfg, shape)
        assert _port_flat(tpart.batch_pspecs(tspecs, tmesh)) == _jax_flat(
            jpart.batch_pspecs(jspecs, jmesh))
    for batch, seq in ((128, 32768), (1, 4096), (6, 96)):
        jcache = jax.eval_shape(lambda: jtr.init_cache(jcfg, batch, seq, jnp.bfloat16))
        tcache = ttr.init_cache(tcfg, batch, seq, torch.bfloat16, device="meta")
        stacked = ttr.jax_layout(tcfg, {"layers": tcache})
        for seq_shard in (False, True):
            want = jpart.cache_pspecs(jcfg, jcache, jmesh, seq_shard=seq_shard)
            got = tpart.cache_pspecs(tcfg, stacked, tmesh, seq_shard=seq_shard)
            assert _port_flat(got) == _jax_flat(want)
            # unstacked: the reference's per-layer cache against the port's
            for kind, c in zip(ttr.layer_kinds(tcfg), tcache):
                jc = jax.eval_shape(lambda kind=kind: jtr._init_layer_cache(
                    jcfg, kind, batch, seq, jnp.bfloat16))
                assert _port_flat(tpart.cache_pspecs(
                    tcfg, c, tmesh, stacked=False, seq_shard=seq_shard)) == _jax_flat(
                    jpart.cache_pspecs(jcfg, jc, jmesh, stacked=False, seq_shard=seq_shard))


def test_reduced_configs_specs_equal_the_reference():
    """The reduced configs the mesh tests run, on their 4 × 2 mesh."""
    jmesh, tmesh = _meshes("4x2")
    for arch in ARCHS:
        jcfg, tcfg = jcfgs.get_reduced_config(arch), tcfgs.get_reduced_config(arch)
        want = jpart.param_pspecs(jcfg, jtr.param_specs(jcfg), jmesh)
        got = tpart.param_pspecs(tcfg, ttr.jax_layout(tcfg, ttr.param_specs(tcfg)), tmesh)
        assert _port_flat(got) == _jax_flat(want), arch


SPECS = [((8, 6), ("data", "model")), ((8, 6), ("model", None)), ((8, 8), (None, "data")),
         ((16, 4, 6), (("pod", "data"), None, "model")), ((4,), ()), ((), ())]


@pytest.mark.parametrize("shape,spec", SPECS)
def test_local_shape_and_shard_round_trip(shape, spec):
    if "pod" in str(spec):
        mesh = Mesh(["cpu"] * 8, (2, 2, 2), ("pod", "data", "model"))
    else:
        mesh = make_local_mesh(2, ["cpu"] * 8)
    want = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        want.append(dim // int(np.prod([mesh.shape[a] for a in axes] or [1])))
    assert tpart.local_shape(shape, spec, mesh) == tuple(want)
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    sh = tpart.shard(t, tpart.PartitionSpec(*spec), mesh)
    for pos in mesh.positions():
        local = sh.local(pos)
        assert tuple(local.shape) == tuple(want)
        idx = tuple(slice(lo, hi) for lo, hi in sh.region(sh.block_of(pos)))
        assert torch.equal(local, t[idx])
    assert torch.equal(tpart.unshard(sh, "cpu"), t)
    if t.dim() >= 2:  # a region across blocks, and a write back into them
        region = ((1, shape[0] - 1), (1, shape[1]))
        assert torch.equal(sh.read(region, "cpu"), t[1:shape[0] - 1, 1:])
        sh.write(region, -t[1:shape[0] - 1, 1:])
        t[1:shape[0] - 1, 1:] *= -1
        assert torch.equal(tpart.unshard(sh, "cpu"), t)


def test_local_shape_rejects_a_dim_the_axes_do_not_divide():
    with pytest.raises(ValueError):
        tpart.local_shape((6, 4), ("data", None), make_production_mesh())
