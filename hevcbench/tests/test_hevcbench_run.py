"""A tiny CPU rehearsal of the cells: the contract's last line, the check
judging the frames the window produced, and the exit without a card."""

import json
import math

import pytest

from hevcbench import check, run
from hevcbench.tests.helpers import small_cell

SEED = 2 ** 31 + 77


def _rehearse(name, trace=False, fault=None, seconds=1.0):
    import torch
    torch.set_num_threads(1)
    return run.run_cell(small_cell(name), SEED, seconds, trace,
                        device="cpu", fault=fault)


@pytest.mark.parametrize("name", ["ai720_cu16.qp32",
                                  "ippp720_fpel.seg2s_qp32"])
def test_a_rehearsal_prints_the_contracts_line(name):
    line = json.loads(json.dumps(_rehearse(name)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "limits"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"fps", "frame_p95_ms", "kbps",
                                    "psnr_y_db", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["limits"]) == set(check.LIMITS)


def test_a_traced_rehearsal_reads_the_span_and_counter_metrics():
    res = _rehearse("ippp720_fpel.seg2s_qp32", trace=True, seconds=1.5)
    got = set(res["metrics"])
    # the device trace's metrics need the card; the rest read here
    assert {"pipeline_self_ms", "intra_ms", "intra_ops_per_frame",
            "inter_ms", "inter_ops_per_frame", "serialize_ms"} <= got
    assert not got & {"me_sad_roofline_pct", "device_idle_pct"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_without_a_card_it_exits_2_and_prints_no_result(capsys,
                                                         monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(run.cells.HERE + "/..")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "ai720_cu16.qp32", "--seed", str(SEED),
                  "--seconds", "1"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_main_prints_the_line_last_and_the_limits_last_on_stderr(
        capsys, monkeypatch):
    import functools
    monkeypatch.setattr(run, "require_cards", lambda n: None)
    cell = small_cell("ai720_cu16.qp32")
    monkeypatch.setattr(run.cells, "load_cell", lambda name, manifest: cell)
    monkeypatch.setattr(run, "run_cell", functools.partial(
        run.run_cell, device="cpu"))
    assert run.main(["--workload", "ai720_cu16.qp32", "--seed", str(SEED),
                     "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "limits"
    tail = err.strip().splitlines()[-len(check.LIMITS):]
    assert [t.split()[0] for t in tail] == list(check.LIMITS)
    assert any(t.startswith("[env] cards") for t in err.splitlines())


def test_a_run_reexecutes_itself_once_pinned_and_steady(monkeypatch):
    import ctypes
    seen = {}

    class _Libc:
        def personality(self, p):
            seen.setdefault("personality", []).append(p)
            return 0

    class _Exec(Exception):
        pass

    def execve(path, argv, env):
        seen.update(argv=argv, env=env)
        raise _Exec
    monkeypatch.delenv("HEVCBENCH_T_START", raising=False)
    monkeypatch.setattr(ctypes, "CDLL", lambda *a, **k: _Libc())
    monkeypatch.setattr(run.os, "sched_setaffinity",
                        lambda pid, cores: seen.update(cores=list(cores)))
    monkeypatch.setattr(run.os, "execve", execve)
    monkeypatch.setattr(run.sys, "argv", ["run.py", "--seed", "5"])
    with pytest.raises(_Exec):
        run.steady_process()
    assert seen["argv"][1:] == ["-m", "hevcbench.run", "--seed", "5"]
    assert seen["env"]["PYTHONHASHSEED"] == "0"
    assert float(seen["env"]["HEVCBENCH_T_START"]) == run.T_START
    assert len(seen["cores"]) == min(run.HOST_CORES,
                                     len(run.os.sched_getaffinity(0)))
    assert seen["env"]["OMP_NUM_THREADS"] == str(len(seen["cores"]))
    assert seen["personality"][-1] & run.ADDR_NO_RANDOMIZE
    # the re-executed process goes on with the run
    monkeypatch.setenv("HEVCBENCH_T_START", "1.0")
    run.steady_process()
