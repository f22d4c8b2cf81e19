"""No module of the port loads JAX or the JAX package.

Each module (and ``chip_smoke``, which the card's machine runs without
JAX) is imported alone in a fresh interpreter, which then must hold
neither ``jax``, ``jaxlib`` nor ``niftymatch_tpu`` in ``sys.modules``.  A
new module is covered by adding its name to ``MODULES``;
``test_every_module_is_listed`` fails until it is.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

MODULES = [
    "niftymatch_torch",
    "niftymatch_torch.config",
    "niftymatch_torch.convert",
    "niftymatch_torch.data",
    "niftymatch_torch.data.euroc",
    "niftymatch_torch.data.native_loader",
    "niftymatch_torch.data.png",
    "niftymatch_torch.data.synthetic",
    "niftymatch_torch.data.tum",
    "niftymatch_torch.dryrun",
    "niftymatch_torch.features",
    "niftymatch_torch.geometry",
    "niftymatch_torch.geometry.fivepoint",
    "niftymatch_torch.geometry.linalg",
    "niftymatch_torch.geometry.ransac",
    "niftymatch_torch.geometry.transforms",
    "niftymatch_torch.kernels",
    "niftymatch_torch.kernels._build",
    "niftymatch_torch.kernels.fold",
    "niftymatch_torch.kernels.linalg",
    "niftymatch_torch.kernels.match",
    "niftymatch_torch.kernels.ransac",
    "niftymatch_torch.kernels.refine",
    "niftymatch_torch.kernels.windows",
    "niftymatch_torch.mosaic",
    "niftymatch_torch.ops",
    "niftymatch_torch.ops.descriptor",
    "niftymatch_torch.ops.filters",
    "niftymatch_torch.ops.gradients",
    "niftymatch_torch.ops.image",
    "niftymatch_torch.ops.keypoints",
    "niftymatch_torch.ops.match",
    "niftymatch_torch.ops.orientation",
    "niftymatch_torch.ops.patches",
    "niftymatch_torch.ops.pyramid",
    "niftymatch_torch.ops.warp",
    "niftymatch_torch.parallel",
    "niftymatch_torch.parallel.ba",
    "niftymatch_torch.parallel.comm",
    "niftymatch_torch.parallel.matching",
    "niftymatch_torch.parallel.mesh",
    "niftymatch_torch.parallel.multihost",
    "niftymatch_torch.parallel.spawn",
    "niftymatch_torch.sfm",
    "niftymatch_torch.sfm.ba",
    "niftymatch_torch.sfm.ba_cg",
    "niftymatch_torch.sfm.homography",
    "niftymatch_torch.sfm.posegraph",
    "niftymatch_torch.sfm.se3",
    "niftymatch_torch.sfm.sim3",
    "niftymatch_torch.sfm.triangulation",
    "niftymatch_torch.sfm.two_view_refine",
    "niftymatch_torch.sift",
    "niftymatch_torch.slam",
    "niftymatch_torch.slam.closure",
    "niftymatch_torch.slam.frontend",
    "niftymatch_torch.slam.globalba",
    "niftymatch_torch.slam.keyframe",
    "niftymatch_torch.slam.reloc",
    "niftymatch_torch.slam.store",
    "niftymatch_torch.slam.system",
    "niftymatch_torch.utils",
    "niftymatch_torch.utils.checkpoint",
    "niftymatch_torch.utils.metrics",
    "niftymatch_torch.utils.precision",
    "niftymatch_torch.utils.profiling",
    "niftymatch_torch.utils.smoke_closure",
    "niftymatch_torch.utils.smoke_dataset",
    "niftymatch_torch.utils.smoke_fold",
    "niftymatch_torch.utils.smoke_linalg",
    "niftymatch_torch.utils.smoke_ransac",
    "niftymatch_torch.utils.smoke_parallel",
    "niftymatch_torch.utils.smoke_sfm",
    "niftymatch_torch.utils.smoke_slam",
    "niftymatch_torch.utils.timing",
    "chip_smoke",
]

_CHECK = (
    "import importlib, sys; importlib.import_module(sys.argv[1]); "
    "bad = sorted(m for m in sys.modules "
    "if m.split('.')[0] in ('jax', 'jaxlib', 'niftymatch_tpu')); "
    "print(bad); sys.exit(1 if bad else 0)"
)


def _import_alone(module):
    return subprocess.run([sys.executable, "-c", _CHECK, module], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def imports():
    """Every module's fresh-interpreter import, four at a time."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(zip(MODULES, pool.map(_import_alone, MODULES)))


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax(imports, module):
    out = imports[module]
    assert out.returncode == 0, out.stdout + out.stderr


def test_every_module_is_listed():
    pkg = REPO / "niftymatch_torch"
    found = {".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
             for p in pkg.rglob("*.py")}
    assert found == set(MODULES) - {"chip_smoke"}
