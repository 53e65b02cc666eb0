"""Nothing the harness loads is JAX, Flax or the JAX package (top-level
names compared whole: the port's name only begins with the JAX package's),
and the reference loads nothing of the port either."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import h100bench

ROOT = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "multi_degradation_image_enhancement_tpu"}
PORT = "multi_degradation_image_enhancement_tpu_torch"


def _loaded_after(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(package):
    return [m.name for m in pkgutil.walk_packages(package.__path__, package.__name__ + ".")
            if ".tests" not in m.name and not m.name.endswith("conftest")]


def test_the_harness_and_the_port_it_drives_load_no_jax():
    modules = _modules(h100bench) + [
        f"{PORT}.models.cdan_fast", f"{PORT}.engine.model", f"{PORT}.ops.losses"]
    assert not (_loaded_after(modules) & JAX)


def test_the_reference_loads_neither_jax_nor_the_port():
    import h100bench.reference as ref

    loaded = _loaded_after(["h100bench.reference"] + _modules(ref))
    assert not (loaded & (JAX | {PORT}))
