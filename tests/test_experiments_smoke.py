"""Smoke-run the standalone experiment scripts at tiny sizes.

A latent crash in an experiment script would otherwise first show on the
GPU, where it wastes the run.  These tests execute each script end-to-end
(tiny shapes, CPU) in a scratch cwd and check the artifact schema.
"""

import json
import runpy
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(script, argv, tmp_path, monkeypatch):
    # The scripts point JAX's persistent compile cache at the repo; a test
    # must not leave that setting behind in its worker.
    from lqp_py_tpu.utils import compile_cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [script.name] + argv)
    monkeypatch.syspath_prepend(str(REPO))
    runpy.run_path(str(script), run_name="__main__")


def test_ip_accuracy_smoke(tmp_path, monkeypatch):
    _run(REPO / "experiments" / "experiment_ip_accuracy.py",
         ["--sizes", "24", "--n-batch", "4", "--n-reps", "1"],
         tmp_path, monkeypatch)
    art = json.loads((tmp_path / "ip_accuracy_results.json").read_text())
    cells = art["cells"]
    # 2 IP solvers x 3 refine x 2 polish, plus ADMM with/without polish.
    assert len(cells) == 14
    for c in cells:
        assert c["solver"] in ("OptNet_IP", "BoxIP", "ADMM")
        assert c["max_dev_x_vs_tight"] < 1e-1
        assert c["fwd_s"] > 0
    admm = {c["polish"]: c for c in cells if c["solver"] == "ADMM"}
    # The polished solve must not be meaningfully worse than the plain
    # one.  NOT a strict <=: both cells measure distance to an eps=1e-6
    # f32 ADMM comparator whose own error (~1e-6) dominates when the
    # polished point is more accurate than the comparator itself.
    assert (admm[True]["max_dev_x_vs_tight"]
            <= admm[False]["max_dev_x_vs_tight"] * 1.5 + 1e-5)
    # Polish must not degrade accuracy vs the unpolished cell.
    by_key = {(c["solver"], c["refine_steps"], c["polish"]): c for c in cells}
    for solver in ("OptNet_IP", "BoxIP"):
        plain = by_key[(solver, 0, False)]["max_dev_x_vs_tight"]
        polished = by_key[(solver, 0, True)]["max_dev_x_vs_tight"]
        assert polished <= plain * 1.5


def test_exp1_smoke(tmp_path, monkeypatch):
    _run(REPO / "experiments" / "experiment_1.py",
         ["--sizes", "16", "--n-batch", "4", "--n-sims", "1"],
         tmp_path, monkeypatch)
    art = json.loads((tmp_path / "exp1_results.json").read_text())
    cell = art["results"]["16"]
    for mode in ("ADMM_FP", "ADMM_KKT", "ADMM_Unroll", "GenQP",
                 "OptNet_IP", "BoxIP"):
        assert cell[mode]["total"] > 0, mode
        assert cell[mode]["max_dev_x_vs_tight"] < 2e-2, mode
        # ADMM_Unroll returns the bare x (reference parity) — no
        # per-element status to count, its gate is the deviation above.
        if mode != "ADMM_Unroll":
            assert cell[mode]["n_converged"] == 4, mode
    assert art["n_sims"] == 1


def test_aa_experiment_smoke(tmp_path, monkeypatch):
    _run(REPO / "experiments" / "experiment_aa.py",
         ["--sizes", "16", "--n-batch", "4", "--windows", "4",
          "--n-sims", "1"],
         tmp_path, monkeypatch)
    art = json.loads((tmp_path / "exp_aa_results.json").read_text())
    for key in ("hard_n16", "create_n16"):
        cell = art["results"][key]
        for sk in ("box_aa0", "box_aa4", "gen_aa0", "gen_aa4"):
            assert cell[sk]["iters"] > 0
            assert cell[sk]["n_converged"] == 4, (key, sk)
        for sk in ("box_aa4", "gen_aa4"):
            assert cell[sk]["max_dev_vs_plain"] < 1e-2
