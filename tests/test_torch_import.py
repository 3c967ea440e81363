"""
Importing the port and running a 64^2 fused optimize, a padded GS
optimize, a compressed WGS-Kim optimize, a camera-in-the-loop WGS-Kim
optimize on a simulated rig, a two-plane multiplane optimize and a batch
of two on the CPU loads none of jax,
cv2, h5py, matplotlib, tqdm, triton or the JAX package, and needs no
``nvcc`` (nor imports the compressed kernels' module). It runs in a
subprocess: this test process has already imported jax
(tests/conftest.py). ``import torch`` itself pulls in tqdm when it is
installed (through torch.hub), so the check is on what the port adds.
A static check reads every module of the port and ``chip_smoke.py``
with ``ast``: none imports jax or the JAX package, and none imports
``cv2`` or ``tqdm`` outside a function (the machine with the card has
neither).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    before = set(sys.modules)
    import slmsuite_torch
    slmsuite_torch.set_default_device("cpu")
    from slmsuite_torch.holography.algorithms import SpotHologram
    holo = SpotHologram.make_rectangular_array(
        (64, 64), array_shape=(4, 4), array_pitch=(8, 8), basis="knm")
    holo.reset_phase(custom_phase=np.random.default_rng(0).uniform(-np.pi, np.pi, (64, 64)))
    holo.optimize(method="WGS-Kim", maxiter=5, stat_groups=["computational"], verbose=False)
    padded = SpotHologram.make_rectangular_array(
        (128, 128), array_shape=(4, 4), array_pitch=(8, 8), basis="knm", slm_shape=(64, 64))
    padded.optimize(method="GS", maxiter=3, verbose=False)
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    compressed = CompressedSpotHologram(
        [[1e-3, -2e-3], [0.0, 1e-3], [0.0, 1e-6]], cameraslm=SimulatedSLM((32, 32)))
    compressed.optimize("WGS-Kim", maxiter=3, verbose=False)
    from slmsuite_torch.models.engine_models import camera_loop_wgs
    rig, camera_loop = camera_loop_wgs(
        spot_ij=[[24.0, 40.0], [32.0, 32.0]], shape=(128, 128), slm_side=64, cam_side=64,
        M=np.array([[1.0e3, 0.0], [0.0, 1.0e3]]))
    camera_loop.optimize("WGS-Kim", maxiter=3, verbose=False, feedback="experimental_spot",
                         stat_groups=["experimental_spot"])
    rig.cam.get_image()
    from slmsuite_torch.holography.algorithms import Hologram, MultiplaneHologram, optimize_batch
    planes = [Hologram(holo.target, propagation_kernel=np.full((64, 64), 0.1 * b, np.float32))
              for b in range(2)]
    MultiplaneHologram(planes).optimize("WGS-Kim", maxiter=3, verbose=False,
                                        stat_groups=["computational"])
    optimize_batch([Hologram(holo.target), Hologram(holo.target)], "WGS-Kim", maxiter=3,
                   verbose=False)
    for cg in (Hologram(holo.target), compressed, MultiplaneHologram(planes)):
        cg.optimize("CG", maxiter=2, verbose=False)
    compressed_module = sys.modules.get("slmsuite_torch.ops.cuda_compressed")
    added = sorted({m.split(".")[0] for m in set(sys.modules) - before})
    cuda_fft = sys.modules.get("slmsuite_torch.ops.cuda_fft")
    print(json.dumps({
        "added": added,
        "built": (cuda_fft is not None and cuda_fft._LIB is not None)
                 or compressed_module is not None,
        "efficiency": holo.stats["stats"]["computational"]["efficiency"][-1],
    }))
""")


def test_port_imports_no_jax_and_needs_no_nvcc():
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin")
    done = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr
    result = json.loads(done.stdout.strip().splitlines()[-1])
    forbidden = {"jax", "jaxlib", "optax", "cv2", "h5py", "matplotlib", "tqdm", "triton",
                 "slmsuite_tpu"}
    assert not forbidden & set(result["added"]), result["added"]
    assert not result["built"]
    assert 0 < result["efficiency"] <= 1


def _port_sources():
    package = os.path.join(ROOT, "slmsuite_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for folder, _, files in os.walk(package):
        paths += [os.path.join(folder, f) for f in sorted(files) if f.endswith(".py")]
    return paths


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_port_source_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax, optax
    (which imports jax) or the JAX package (docstrings that name them are
    fine)."""
    with open(path) as handle:
        tree = ast.parse(handle.read(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            imported.append(node.module)
    roots = {name.split(".")[0] for name in imported}
    assert not roots & {"jax", "jaxlib", "optax", "slmsuite_tpu"}, sorted(roots)


def _imports_outside_functions(node):
    """Names imported by ``node``'s statements that run on import (not
    those inside a function body)."""
    found = []
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            found += [alias.name for alias in child.names]
        elif isinstance(child, ast.ImportFrom) and child.module and not child.level:
            found.append(child.module)
        found += _imports_outside_functions(child)
    return found


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_port_source_imports_no_cv2_or_tqdm_on_import(path):
    """``cv2`` and ``tqdm`` are imported inside the functions that use
    them, never when a module of the port (or chip_smoke.py) is imported."""
    with open(path) as handle:
        tree = ast.parse(handle.read(), filename=path)
    roots = {name.split(".")[0] for name in _imports_outside_functions(tree)}
    assert not roots & {"cv2", "tqdm"}, sorted(roots)


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_port_source_imports_no_matplotlib_on_import(path):
    """``matplotlib`` (and ``mpl_toolkits``) are imported inside the plot
    functions, never when a module of the port, its examples or
    chip_smoke.py is imported: the machine with the card has none."""
    with open(path) as handle:
        tree = ast.parse(handle.read(), filename=path)
    roots = {name.split(".")[0] for name in _imports_outside_functions(tree)}
    assert not roots & {"matplotlib", "mpl_toolkits", "cv2"}, sorted(roots)


def test_examples_and_remote_files_are_checked():
    """The static checks above read the examples and the remote hardware
    (whose modules import nothing of the JAX package or jax)."""
    checked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for name in ("_rig", "structured_light", "computational_holography",
                 "batched_holography", "zernike_holography", "experimental_holography",
                 "multichip_scaling", "wavefront_calibration", "multipoint_calibration",
                 "remote_hardware"):
        assert os.path.join("slmsuite_torch", "examples", name + ".py") in checked
    for name in ("hardware/remote.py", "hardware/cameras/remote.py", "hardware/slms/remote.py",
                 "misc/profile.py"):
        assert os.path.join("slmsuite_torch", *name.split("/")) in checked
