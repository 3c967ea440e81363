"""
Importing the port and running a 64^2 fused optimize and a padded GS
optimize on the CPU loads none of jax, cv2, h5py, matplotlib, tqdm,
triton or the JAX package, and needs no ``nvcc``. It runs in a
subprocess: this test process has already imported jax
(tests/conftest.py). ``import torch`` itself pulls in tqdm when it is
installed (through torch.hub), so the check is on what the port adds.
A static check reads every module of the port and ``chip_smoke.py``
with ``ast``: none imports jax or the JAX package.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

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
    added = sorted({m.split(".")[0] for m in set(sys.modules) - before})
    cuda_fft = sys.modules.get("slmsuite_torch.ops.cuda_fft")
    print(json.dumps({
        "added": added,
        "built": cuda_fft is not None and cuda_fft._LIB is not None,
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
    forbidden = {"jax", "jaxlib", "cv2", "h5py", "matplotlib", "tqdm", "triton",
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
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (docstrings that name them are fine)."""
    with open(path) as handle:
        tree = ast.parse(handle.read(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            imported.append(node.module)
    roots = {name.split(".")[0] for name in imported}
    assert not roots & {"jax", "jaxlib", "slmsuite_tpu"}, sorted(roots)
