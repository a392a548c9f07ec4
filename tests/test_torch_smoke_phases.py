"""``chip_smoke.py --phases``: the dependency closure, the refusal of an
unknown name, the full run as the default, and the budget line. None of
these needs a card: the options are read before torch is imported."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_default_is_every_phase():
    assert chip_smoke.parse_options([]) == {"mesh_only": False,
                                            "phases": None}
    assert chip_smoke.parse_options(["--mesh-only"]) == {"mesh_only": True,
                                                         "phases": None}
    assert chip_smoke.PHASES[0] == "device_and_build"
    assert len(set(chip_smoke.PHASES)) == len(chip_smoke.PHASES)
    for name in ("bulk_parity", "layout_frontier", "tune_sweep", "timings",
                 "int_probe", "fabric_session", "baseline_matrix"):
        assert name in chip_smoke.PHASES


def test_every_phase_has_its_function_in_order():
    """``run`` maps each name of PHASES to its function, in that order (it
    also asserts so at run time)."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    run = next(n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    table = next(n.value for n in ast.walk(run)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "functions")
    assert tuple(k.value for k in table.keys) == chip_smoke.PHASES


def test_closure_pulls_what_a_phase_needs_in_the_smokes_order():
    closure = chip_smoke.phase_closure(["layout_frontier"])
    assert closure == ["device_and_build", "kernels_vs_plain",
                       "int_probe_vs_plain", "int_probe", "timings",
                       "layout_frontier"]
    assert chip_smoke.phase_closure(["bulk_parity"]) == [
        "device_and_build", "bulk_parity"]
    # The matrix runner builds its own hashers and reads nothing another
    # phase leaves: it runs alone.
    assert chip_smoke.phase_closure(["baseline_matrix"]) == [
        "device_and_build", "baseline_matrix"]
    assert chip_smoke.phase_closure(["perf_capture"]) == [
        "device_and_build", "genesis_sweep", "bench_json", "perf_capture"]
    # Named twice, or named with what it needs: each runs once.
    assert chip_smoke.phase_closure(["timings", "kernels_vs_plain",
                                     "timings"]).count("timings") == 1


@pytest.mark.parametrize("name", sorted(chip_smoke.PHASES))
def test_needs_are_phases_run_before_it(name):
    closure = chip_smoke.phase_closure([name])
    order = {n: i for i, n in enumerate(chip_smoke.PHASES)}
    assert closure == sorted(closure, key=order.get)
    assert closure[0] == "device_and_build" and name in closure
    for need in chip_smoke.PHASE_NEEDS.get(name, ()):
        assert order[need] < order[name], (need, name)
        assert need in closure


def test_grpc_and_mesh_phases_are_phases():
    assert set(chip_smoke.GRPC_PHASES) <= set(chip_smoke.PHASES)
    assert set(chip_smoke.MESH_PHASES) <= set(chip_smoke.PHASES)
    assert set(chip_smoke.PHASE_NEEDS) <= set(chip_smoke.PHASES)


def test_unknown_names_and_bad_options_are_refused():
    with pytest.raises(ValueError, match="unknown phase.*nope.*the phases "
                                         "are: device_and_build"):
        chip_smoke.parse_options(["--phases", "timings,nope"])
    for argv in (["--phases"], ["--phases", ","], ["--frobnicate"],
                 ["--mesh-only", "--phases", "timings"]):
        with pytest.raises(ValueError):
            chip_smoke.parse_options(argv)
    assert chip_smoke.parse_options(["--phases=bulk_parity"])["phases"] == [
        "device_and_build", "bulk_parity"]


def test_unknown_phase_exits_2_with_the_list():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "bulk_parity,nope"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "nope" in proc.stderr
    for name in chip_smoke.PHASES:
        assert name in proc.stderr


def test_no_card_or_no_checkout_prints_no_result(tmp_path):
    """Here (no card) the smoke exits non-zero with no last line, also
    with --phases; alone in a directory it does as well."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "bulk_parity"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_budget_line():
    seconds = {"a": 1.0, "b": 160.04, "c": 3.0, "d": 121.7, "e": 80.4,
               "f": 65.9, "g": 0.5}
    line = chip_smoke.budget_line(seconds, 440.123)
    assert line == {"smoke_seconds": 440.1, "budget_s": 1200,
                    "phases_seconds": 432.5,
                    "longest": [["b", 160.0], ["d", 121.7], ["e", 80.4],
                                ["f", 65.9], ["c", 3.0]]}
    assert chip_smoke.BUDGET_S == 1200


def test_docstring_names_the_new_phases_and_options():
    doc = chip_smoke.__doc__
    for word in ("--phases", "--mesh-only", "bulk_parity", "layout_frontier",
                 "tune_sweep", "baseline_matrix", "probes.run.main",
                 "smoke_seconds", "budget_s"):
        assert word in doc, word


def test_layouts_are_the_packages():
    """The smoke, the parity gate and the ranker drive one layout list."""
    from bitcoin_miner_tpu_torch.ops import sha256_tile

    layouts = chip_smoke.tile_layouts(sha256_tile)
    assert layouts == sha256_tile.driven_layouts()
    assert len(layouts) == 28


def test_matrix_runs_drive_both_kernels_at_full_size():
    """``baseline_matrix`` drives the runner on the tile kernel at its
    defaults and on the hit-buffer kernel at the reference's geometry,
    both at full size (no ``--quick``), and each parses as the runner's
    options."""
    from bitcoin_miner_tpu_torch.probes import run

    assert [label for label, _ in chip_smoke.MATRIX_RUNS] == ["cuda-tile",
                                                              "cuda"]
    for label, argv in chip_smoke.MATRIX_RUNS:
        args = run.build_parser().parse_args(list(argv))
        assert (args.backend, args.device, args.quick, args.batch_bits) == (
            label, "cuda", False, 20)
    assert run.build_parser().parse_args(
        list(chip_smoke.MATRIX_RUNS[1][1])).inner_bits == 14
