"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither JAX nor any module of the JAX package."""
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({{"modules": len(mods), "bad": bad}}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found["modules"] >= 59
    assert found["bad"] == []


def test_no_source_of_the_port_names_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "jaxlib", "repro"), (path, line)


def test_the_distribution_slice_imports_no_jax():
    """The modules of the distribution slice, each alone in a fresh
    interpreter, leave JAX out of ``sys.modules``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for mod in ("repro_torch.dist.sharding", "repro_torch.dist.axes",
                "repro_torch.dist.regions", "repro_torch.launch.mesh",
                "repro_torch.obs.projection", "repro_torch.configs.shapes",
                "repro_torch.perfmodel.hlo"):
        src = os.path.join(ROOT, "src")
        code = (f"import sys; sys.path.insert(0, {src!r}); import {mod}; "
                "print(sorted(k for k in sys.modules "
                "if k.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]", (mod, out.stdout)
