"""The port runs where JAX and the JAX package are not installed (the GPU
machine has no JAX): in a subprocess whose import system refuses jax and
raytracingproject_tpu, every module of raytracingproject_tpu_torch
imports, and the glossy scene, the volume_sss scene (with its pinned
dispatch) and the big_instanced scene compile and render 8x8, 2-spp
images on the CPU, and so do the dense path's cornell_diffuse scene,
volume_sss under the host compile's own dense dispatch and big_instanced
with pallas_onehot2 and the glossy scene in fused-NEE mode, each through
the CLI's scene loader; the fused kernel globals also take one round of
the adaptive loop. The sources import neither jax nor anything of the
JAX package."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "raytracingproject_tpu_torch")
ALLOWED = set()

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "raytracingproject_tpu")

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import numpy as np
import raytracingproject_tpu_torch as P
for m in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
from raytracingproject_tpu_torch.app import examples
from raytracingproject_tpu_torch.session.session import render
img = render(examples.cornell_box(8, 8, spheres="glossy"), samples=2,
             chunk=2, device="cpu")
assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
vs = examples.volume_sss_scene(8, 8, spp=2)
vs.device_update()
kg = vs.make_kernel_globals("cpu")
kg.update(examples.VOLUME_SSS_DISPATCH)
vimg = render(vs, samples=2, chunk=2, device="cpu", kg=kg)
assert vimg.shape == (8, 8, 3) and np.isfinite(vimg).all() and vimg.mean() > 0
bimg = render(examples.instanced_scene(8, 8, spp=2, grid=8), samples=2,
              chunk=2, device="cpu")
assert bimg.shape == (8, 8, 3) and np.isfinite(bimg).all() and bimg.mean() > 0
from raytracingproject_tpu_torch.app import cli
means = []
for spec in ("example:cornell", "example:volume_sss:dense",
             "example:big_instanced:onehot2", "example:cornell:glossy:fused"):
    sc, flags = cli.load_scene(spec)
    sc.camera.set("width", 8)
    sc.camera.set("height", 8)
    sc.device_update()
    kg = sc.make_kernel_globals("cpu")
    kg.update(flags)
    im = render(sc, samples=2, chunk=2, device="cpu", kg=kg)
    assert im.shape == (8, 8, 3) and np.isfinite(im).all() and im.mean() > 0
    means.append(float(im.mean()))
from raytracingproject_tpu_torch.ops import integrator as integ
from raytracingproject_tpu_torch.session.adaptive import render_adaptive_device
assert integ._use_fused_nee(kg)
L, A, counts, st = render_adaptive_device(kg, 8, 8, 4, threshold=0.0, chunk=2,
                                          max_rounds=1)
assert (counts == 2).all() and np.isfinite(L).all() and L.mean() > 0
assert st["dispatches"] == 1 and not st["converged"]
assert not [k for k in sys.modules if k.split(".")[0] in BLOCKED]
print("NOJAX_OK", float(img.mean()), float(vimg.mean()), float(bimg.mean()),
      *means)
"""


def _sources():
    for dp, _dn, fns in os.walk(PKG):
        for fn in fns:
            if fn.endswith(".py"):
                yield os.path.join(dp, fn)


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NOJAX_OK" in r.stdout


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports(path):
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+jax(lib)?\b", src, re.M)
    for mod in re.findall(r"^\s*from\s+(raytracingproject_tpu(?:\.\w+)*)"
                          r"\s+import\s+(\w+)", src, re.M):
        full = {mod[0], f"{mod[0]}.{mod[1]}"}
        assert full & ALLOWED, f"{path} imports {mod}"
    for mod in re.findall(r"^\s*import\s+(raytracingproject_tpu(?:\.\w+)*)",
                          src, re.M):
        assert mod in ALLOWED, f"{path} imports {mod}"
