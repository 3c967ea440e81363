"""A cell added as files and a BENCHMARK.json entry alone runs, with no
edit to the harness's code."""

import json
import shutil

from conftest import ROOT


def test_holobench_new_cell_from_files_only(tmp_path, run_cell):
    shutil.copytree(ROOT / "holobench", tmp_path / "holobench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    (tmp_path / "slmsuite_torch").symlink_to(ROOT / "slmsuite_torch")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    # A new traffic mix of an existing kind (a plain 3D lattice in the kxy
    # basis), and a new configuration file (uniform illumination).
    mix = json.loads((ROOT / "holobench" / "traffic" / "aberr21.json").read_text())
    mix.update(terms=3, spots=[16, 16], iterations=11)
    mix["rehearse"].update(spots=[3, 5], iterations=11)
    (tmp_path / "holobench" / "traffic" / "lattice.json").write_text(json.dumps(mix))
    config = json.loads((ROOT / "holobench" / "configs" / "zernike_1024.json").read_text())
    config["name"] = "zernike_768"
    for slm in (config["slm"], config["rehearse"]["slm"]):
        slm.pop("source")
    config["slm"]["shape"] = [768, 768]
    config["rehearse"]["slm"]["shape"] = [40, 56]
    (tmp_path / "holobench" / "configs" / "zernike_768.json").write_text(json.dumps(config))
    manifest["configs"].append({"name": "zernike_768", "source": "a test's configuration",
                                "file": "holobench/configs/zernike_768.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "zernike_768.lattice", "config": "zernike_768",
                                  "traffic": "lattice", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    line, _ = run_cell("zernike_768.lattice", root=tmp_path)
    assert line["correct"] is True
    assert "holograms_per_s" in line["metrics"]
