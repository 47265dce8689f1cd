"""The port's serve CLI against the reference's on the same command line:
the same request sources (--trace, --requests, --batch, --arrival) with
the same defaults submit the same (prompt, max_new, shard_id) list in the
same order.  Both mains run in this process with their engines replaced
by one recorder, so nothing is served; an empty trace file returns 1 on
both, and a prompt of --max-len tokens or more raises ValueError in both
real engines.  Then the port CLI's --trace-out timeline goes through
scripts/trace_report.py, and config.as_dict equals the reference's."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro import config as j_config
from repro.launch import serve as j_serve
from repro_torch import config as t_config
from repro_torch.launch import serve as t_serve

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stats:
    """What both mains read from ``engine.stats`` after a run."""

    def __init__(self):
        self.latency = self

    def metrics(self, wall_s=None):
        return {"tokens": 0, "goodput_qps": 0.0, "slo_attainment": 1.0}

    def summary(self):
        return "stub"


class _Recorder:
    """Stands in for ServeEngine and ClusterEngine in both mains: records
    every submit and serves nothing."""
    log = None

    def __init__(self, cfg, params, **kw):
        self.clock, self.pending, self.num_active, self.in_flight = \
            0.0, 0, 0, 0
        self.stats = _Stats()

    def submit(self, prompt, max_new=32, shard_id=None, **kw):
        self.log.append((list(prompt), max_new, shard_id, kw))
        return len(self.log) - 1

    def advance_clock(self, t):
        self.clock = max(self.clock, t)

    def step(self):
        return []

    def run_until_complete(self):
        return [SimpleNamespace(rid=i, tokens=[], status="ok")
                for i in range(len(self.log))]

    def summary(self):
        return "stub"

    def kv_stats(self):
        return {"layout": "paged", "peak_kv_bytes": 0, "dense_kv_bytes": 0,
                "page_size": 16}

    def close(self):
        pass


def _run(monkeypatch, mod, argv, stub=True):
    """``mod.main()`` on ``argv``: (return code, submits)."""
    log = []
    if stub:
        for name in ("ServeEngine", "ClusterEngine"):
            monkeypatch.setattr(mod, name, type(name, (_Recorder,),
                                                {"log": log}))
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    return mod.main(), log


def _both(monkeypatch, argv, stub=True):
    """(reference, port) results of ``_run`` on one command line."""
    ref = _run(monkeypatch, j_serve, argv, stub)
    port = _run(monkeypatch, t_serve, argv + ["--device", "cpu"], stub)
    return ref, port


def _trace_file(tmp_path):
    path = tmp_path / "prompts.txt"
    path.write_text("# three requests, two with their own max_new\n"
                    "1 2 3 4 5\n"
                    "\n"
                    "  7 8 9 | 3\n"
                    "# a comment between requests\n"
                    "10 11 12 13 14 15 16 17|12\n")
    return str(path)


SMOKE = ["--arch", "yi-9b", "--smoke"]


@pytest.mark.parametrize("argv, n, shards", [
    ([], 4, None),
    (["--requests", "6"], 6, None),
    (["--batch", "3", "--prompt-len", "10"], 3, None),
    (["--arrival", "bursty"], 32, None),
    (["--replicas", "2", "--shards", "2", "--requests", "5"], 5,
     [0, 1, 0, 1, 0]),
], ids=["defaults", "requests", "batch", "arrival", "cluster-shards"])
def test_same_command_line_submits_the_same_requests(monkeypatch, argv, n,
                                                     shards):
    (rc_ref, ref), (rc_port, port) = _both(monkeypatch, SMOKE + argv)
    assert rc_ref == rc_port == 0
    assert len(ref) == n
    assert port == ref
    if shards is not None:
        assert [s for _, _, s, _ in port] == shards
    if not argv:        # the reference's defaults: --batch 4 of 32 tokens
        assert [(len(p), m) for p, m, _, _ in port] == [(32, 32)] * 4


def test_trace_file_is_served_as_written(monkeypatch, tmp_path):
    path = _trace_file(tmp_path)
    (rc_ref, ref), (rc_port, port) = _both(
        monkeypatch, SMOKE + ["--trace", path, "--max-new", "6"])
    assert rc_ref == rc_port == 0
    assert port == ref == [([1, 2, 3, 4, 5], 6, None, {}),
                           ([7, 8, 9], 3, None, {}),
                           (list(range(10, 18)), 12, None, {})]
    assert t_serve._load_trace(path, 6) == j_serve._load_trace(path, 6)


def test_empty_trace_returns_one_with_the_same_line(monkeypatch, capsys,
                                                    tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text("# nothing to serve\n\n")
    argv = SMOKE + ["--trace", str(path)]
    assert _run(monkeypatch, j_serve, argv) == (1, [])
    ref_out = capsys.readouterr().out
    assert _run(monkeypatch, t_serve, argv + ["--device", "cpu"]) == (1, [])
    port_out = capsys.readouterr().out
    line = "[serve] no requests (empty --trace file?)"
    assert ref_out.splitlines() == port_out.splitlines() == [line]


def test_prompt_past_max_len_raises_in_both_engines(monkeypatch):
    """No clamp on the drawn lengths: the engine's own check refuses the
    first prompt of --max-len tokens or more, as the reference's does."""
    argv = SMOKE + ["--prompt-len", "64", "--max-len", "48", "--requests",
                    "4", "--num-slots", "2"]
    for mod, extra in ((j_serve, []), (t_serve, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="max_len"):
            _run(monkeypatch, mod, argv + extra, stub=False)


@pytest.mark.parametrize("argv", [[], ["--replicas", "2"]],
                         ids=["engine", "cluster"])
def test_port_trace_out_loads_through_trace_report(monkeypatch, tmp_path,
                                                   argv):
    """The port CLI's Perfetto timeline from a short CPU run passes the
    report tool's structural checks and names its tracks."""
    out = tmp_path / "trace.json"
    rc, _ = _run(monkeypatch, t_serve, SMOKE + [
        "--requests", "3", "--max-new", "4", "--max-len", "48",
        "--num-slots", "2", "--device", "cpu", "--trace-out", str(out)]
        + argv, stub=False)
    assert rc == 0
    spec = importlib.util.spec_from_file_location(
        "trace_report", REPO / "scripts" / "trace_report.py")
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    events = tr.load_trace(str(out))
    names = set(tr.track_names(events).values())
    assert "requests" in names, names
    if argv:
        assert {"coordinator", "drive0", "drive1"} <= names, names
    slow = tr.slowest_requests(events, tr.track_names(events), top=5)
    assert len(slow) == 3
    assert sum(n for n, _ in tr.phase_breakdown(events).values()) > 0


@pytest.mark.parametrize("arch", j_config.list_configs())
def test_as_dict_equals_the_reference(arch):
    assert t_config.list_configs() == j_config.list_configs()
    assert t_config.as_dict(t_config.reduced_config(arch)) == \
        j_config.as_dict(j_config.reduced_config(arch))
    assert t_config.as_dict(t_config.get_config(arch)) == \
        j_config.as_dict(j_config.get_config(arch))
