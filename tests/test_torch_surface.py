"""The port's public surface against the JAX package's.

For every module under ``src/repro/`` (``analysis/`` aside: the stdlib
checker runs over both packages as it is) the walk collects the public
names a user reaches: a package's exports (``__all__``, its eager imports
from its own submodules, its lazy PEP 562 tables), a module's own public
functions, classes and UPPER_CASE constants, and the public methods and
properties of each of its classes. Each must resolve on the port's
counterpart, except the deliberate differences in ``DELIBERATE``. Then:
importing ``repro_torch.core``, ``.graphs`` or ``.models`` loads none of
their submodules; each re-export is the object of its defining module;
and the two methods this surface added hold to the reference's
(``Schedule.device_step_ranges``, ``launch.steps.model_shardings``)."""
import dataclasses
import importlib
import inspect
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
REF_ROOT = REPO / "src" / "repro"

#: reference module -> port module, where the port's file has another name
RENAMED = {"repro.kernels.spmm_pallas": "repro_torch.kernels.spmm_cuda",
           "repro.kernels.flash_attention": "repro_torch.kernels.flash_attention_cuda"}

#: reference name -> (its defining reference module, the port's counterpart
#: in the port's module of that name or None, why the port differs)
DELIBERATE = {
    "execute_schedule_jnp": ("repro.core.schedule", "execute_schedule_torch",
                             "the port runs the schedule's body in torch ops"),
    "collective_bytes_from_hlo": ("repro.roofline.analysis", "collective_bytes",
                                  "reads XLA HLO; the port's wire comes from "
                                  "spmd.program_collectives"),
    "tpu_hbm_bytes_from_hlo": ("repro.roofline.analysis", "hbm_bytes_from_ops",
                               "reads XLA HLO; the port counts HBM bytes from its "
                               "op log on the meta device"),
    "lower_unit": ("repro.launch.dryrun", None,
                   "lowers one scanned unit for XLA; the port counts full depth "
                   "on the meta device"),
    "extrapolated_totals": ("repro.launch.dryrun", None,
                            "extrapolates lowered units to full depth; the port "
                            "needs no extrapolation"),
}

_UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _reference_modules() -> list:
    out = []
    for path in sorted(REF_ROOT.rglob("*.py")):
        parts = list(path.relative_to(REF_ROOT.parent).with_suffix("").parts)
        if parts[1] == "analysis":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


REF_MODULES = _reference_modules()


def _port_name(ref_name: str) -> str:
    return RENAMED.get(ref_name, "repro_torch" + ref_name[len("repro"):])


def _public(name: str) -> bool:
    return not name.startswith("_")


def _is_constant(name: str, value) -> bool:
    return bool(_UPPER.match(name)) and not callable(value) and not isinstance(
        value, types.ModuleType)


def _class_members(cls) -> set:
    kinds = (types.FunctionType, property, staticmethod, classmethod)
    return {f"{cls.__name__}.{m}" for m, a in vars(cls).items()
            if _public(m) and isinstance(a, kinds)}


def public_surface(mod) -> set:
    """The names of ``mod`` a user reaches (module note); ``Class.member``
    for a class's methods and properties."""
    ns = vars(mod)
    names = {n for n in dir(mod) if _public(n) and n not in ns}  # lazy tables
    if "__path__" in ns:
        names |= set(ns.get("__all__", ()))
        for n, v in ns.items():
            if _public(n) and not isinstance(v, types.ModuleType) and (
                    str(getattr(v, "__module__", "")).startswith(mod.__name__ + ".")
                    or _is_constant(n, v)):
                names.add(n)
    for n, v in ns.items():
        if not _public(n):
            continue
        if ((inspect.isfunction(v) or inspect.isclass(v))
                and getattr(v, "__module__", None) == mod.__name__):
            names.add(n)
            if inspect.isclass(v):
                names |= _class_members(v)
        elif _is_constant(n, v):
            names.add(n)
    return names


def _import_reference(name: str):
    """Import a module of the JAX package and leave the process as it was.
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices on
    import, meant for its own process: the backend is brought up first, so
    the flag cannot take effect here, and the variable is restored for
    later tests and the subprocesses they start."""
    import jax

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _resolves(mod, dotted: str) -> bool:
    obj = mod
    for part in dotted.split("."):
        try:
            obj = getattr(obj, part)
        except AttributeError:
            return False
    return True


def test_importing_the_reference_leaves_the_environment_as_it_was():
    import jax

    before = (os.environ.get("XLA_FLAGS"), jax.device_count())
    _import_reference("repro.launch.dryrun")
    assert (os.environ.get("XLA_FLAGS"), jax.device_count()) == before


def test_the_walk_covers_every_reference_module():
    assert len(REF_MODULES) == len(set(REF_MODULES)) > 60
    for name in ("repro.core", "repro.core.schedule", "repro.kernels.spmm_pallas",
                 "repro.roofline.analysis", "repro.launch.dryrun", "repro.lazyexports"):
        assert name in REF_MODULES
    assert not [m for m in REF_MODULES if m.startswith("repro.analysis")]
    for ref, port in RENAMED.items():
        assert ref in REF_MODULES
        assert (REPO / "src" / (port.replace(".", "/") + ".py")).exists()


@pytest.mark.parametrize("ref_name", REF_MODULES)
def test_every_public_name_resolves_on_the_port(ref_name):
    ref = _import_reference(ref_name)
    port = importlib.import_module(_port_name(ref_name))
    names = public_surface(ref)
    missing = sorted(n for n in names if not _resolves(port, n))
    allowed = []
    for n in missing:
        entry = DELIBERATE.get(n)
        if entry is None:
            continue
        home, counterpart, reason = entry
        assert getattr(ref, n).__module__ == home, (n, reason)
        if counterpart is not None:
            assert _resolves(port, counterpart), (n, counterpart)
        allowed.append(n)
    assert [n for n in missing if n not in allowed] == []


def test_the_deliberate_differences_are_still_differences():
    """Each entry of ``DELIBERATE`` names a reference name the port lacks,
    so the table cannot outlive the difference it records."""
    for name, (home, counterpart, _) in DELIBERATE.items():
        ref = _import_reference(home)
        port = importlib.import_module(_port_name(home))
        assert hasattr(ref, name)
        assert not hasattr(port, name), name
        if counterpart is not None:
            assert callable(getattr(port, counterpart))


def test_the_walk_finds_a_missing_name():
    """The walk sees a method, a lazy export and a re-exported constant."""
    class Fake:
        def method(self):
            pass

        @property
        def prop(self):
            return 1

    Fake.__module__ = "fake"
    mod = types.ModuleType("fake")
    mod.Fake, mod.LIMIT, mod.helper = Fake, 3, len
    mod.__getattr__ = lambda n: 0
    mod.__dir__ = lambda: ["Fake", "LIMIT", "helper", "lazy_name"]
    assert public_surface(mod) == {"Fake", "Fake.method", "Fake.prop", "LIMIT",
                                   "lazy_name"}
    other = types.ModuleType("other")
    other.Fake = type("Fake", (), {"method": lambda self: None})
    assert not _resolves(other, "Fake.prop")
    assert _resolves(other, "Fake.method")


# ---------------------------------------------------------------------------
# the three packages that forward names: lazy, and the same objects
# ---------------------------------------------------------------------------

PACKAGES = {"repro_torch.core": ("repro.core", {"execute_schedule_jnp"}),
            "repro_torch.graphs": ("repro.graphs", set()),
            "repro_torch.models": ("repro.models", set())}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_importing_the_package_loads_none_of_its_submodules(pkg):
    code = ("import sys, importlib; "
            f"m = importlib.import_module({pkg!r}); "
            f"sub = sorted(k for k in sys.modules if k.startswith({pkg + '.'!r})); "
            "assert sub == [], sub; "
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')]; "
            "assert bad == [], bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_each_re_export_is_its_defining_modules_object(pkg):
    port = importlib.import_module(pkg)
    ref_name, renamed = PACKAGES[pkg]
    ref = _import_reference(ref_name)
    lazy = [n for n in dir(port) if _public(n) and n not in vars(port)]
    assert sorted(lazy) == sorted(port._EXPORTS)
    want = {n for n in public_surface(ref) if n not in renamed}
    assert want <= set(lazy)
    for name in lazy:
        obj = getattr(port, name)
        target = importlib.import_module(port._EXPORTS[name])
        assert getattr(target, name) is obj, (pkg, name)
        home = getattr(obj, "__module__", None)  # a dict constant has none
        if home is not None:
            assert getattr(importlib.import_module(home), name) is obj, (pkg, name)
    for name in renamed:  # its counterpart is exported in its place
        assert not hasattr(port, name)
    with pytest.raises(AttributeError, match="has no attribute 'nope'"):
        port.nope  # noqa: B018


def test_the_engine_module_re_exports_the_headroom_constants():
    from repro.serving import gcn_engine as jeng
    from repro_torch.serving import gcn_engine as teng
    from repro_torch.serving import policy

    assert teng.SVC_SAFETY is policy.SVC_SAFETY == jeng.SVC_SAFETY
    assert teng.SVC_FLOOR_S is policy.SVC_FLOOR_S == jeng.SVC_FLOOR_S
    assert teng._SVC_SAFETY == jeng._SVC_SAFETY
    assert teng._SVC_FLOOR_S == jeng._SVC_FLOOR_S


# ---------------------------------------------------------------------------
# Schedule.device_step_ranges
# ---------------------------------------------------------------------------


def _schedules():
    from repro.core import schedule as jsched
    from repro.graphs import synth as jsynth
    from repro_torch.core import schedule as tsched
    from repro_torch.graphs import synth as tsynth

    ta = tsynth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    ja = jsynth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    return (tsched.build_balanced_schedule(ta, 16, 8),
            jsched.build_balanced_schedule(ja, 16, 8))


@pytest.mark.parametrize("n_steps", [0, 1, 3, 7, 64, None])
def test_device_step_ranges_equal_the_reference(n_steps):
    ts, js = _schedules()
    if n_steps is not None:
        ts = dataclasses.replace(ts, win_id=ts.win_id[:n_steps])
        js = dataclasses.replace(js, win_id=js.win_id[:n_steps])
    assert ts.n_steps == js.n_steps
    for n_devices in (1, 2, 3, 4, 5, 8, 13, max(1, ts.n_steps), ts.n_steps + 3):
        got = ts.device_step_ranges(n_devices)
        want = js.device_step_ranges(n_devices)
        assert np.array_equal(got, want), (ts.n_steps, n_devices)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError):
        ts.device_step_ranges(0)


# ---------------------------------------------------------------------------
# launch.steps.model_shardings
# ---------------------------------------------------------------------------


def _flat(tree, prefix="") -> dict:
    from repro_torch.sharding import partition as tpart

    if isinstance(tree, (tpart.PartitionSpec, torch.Tensor)):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _stacked_key(cfg, key: str) -> tuple:
    """The reference's stacked path of a port-layout leaf, and whether the
    stacked leaf carries a leading layer axis."""
    if key.startswith("encoder/"):
        _, _, rest = key.split("/", 2)
        return f"encoder/l0/{rest}", True
    if not key.startswith("layers/"):
        return key, False
    _, at, rest = key.split("/", 2)
    at = int(at)
    for si, (unit, repeat) in enumerate(cfg.segments):
        if at < len(unit) * repeat:
            return f"seg{si}/l{at % len(unit)}/{rest}", True
        at -= len(unit) * repeat
    raise KeyError(key)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b"])
def test_model_shardings_equal_the_reference_param_pspecs(arch):
    import jax
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as JP

    from repro import configs as jcfgs
    from repro.models import transformer as jtr
    from repro.sharding import partition as jpart
    from repro_torch import configs as tcfgs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh

    jcfg, tcfg = jcfgs.get_reduced_config(arch), tcfgs.get_reduced_config(arch)
    jmesh = AbstractMesh((4, 2), ("data", "model"))
    tmesh = Mesh(["meta"] * 8, (4, 2), ("data", "model"))
    jspecs = jtr.param_specs(jcfg)
    def key(path) -> str:
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jpart.param_pspecs(jcfg, jspecs, jmesh), is_leaf=lambda x: isinstance(x, JP))
    want = {key(path): tuple(s) for path, s in leaves}
    shapes, _ = jax.tree_util.tree_flatten_with_path(jspecs)
    want_shapes = {key(path): tuple(s.shape) for path, s in shapes}

    specs, pspecs = steps.model_shardings(tcfg, tmesh)
    flat_specs, flat_pspecs = _flat(specs), _flat(pspecs)
    assert flat_specs.keys() == flat_pspecs.keys()
    assert len({_stacked_key(tcfg, k)[0] for k in flat_pspecs}) == len(want)
    for key, spec in flat_pspecs.items():
        ref_key, stacked = _stacked_key(tcfg, key)
        assert ((None,) if stacked else ()) + tuple(spec) == want[ref_key], key
        leaf = flat_specs[key]
        assert leaf.device.type == "meta" and leaf.dtype == torch.bfloat16
        assert tuple(leaf.shape) == want_shapes[ref_key][1 if stacked else 0:], key
    # one device: the same specs, nothing partitioned
    one, none = steps.model_shardings(tcfg, None)
    assert none is None
    assert {k: (v.shape, v.dtype) for k, v in _flat(one).items()} == {
        k: (v.shape, v.dtype) for k, v in flat_specs.items()}
