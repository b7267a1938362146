"""The port's profiling (``faster_distributed_training_tpu_torch/utils/
profiling.py``) against the JAX package's (``utils/profiling.py``).

  * ``parse_profile_steps`` equals JAX's on a table of specs, the
    refusals included;
  * ``StepWindowProfiler``: with both packages' start and stop replaced
    by recorders, the same start / stop decisions, ``started_at`` /
    ``stopped_at`` and fence calls at K=1 and K=4, for a resume past the
    window, a resume inside it and a run that ends before the window does
    (JAX ``tests/test_telemetry.py::TestStepWindowProfiler``);
  * ``peak_memory_bytes`` / ``memory_watermarks``: None on the CPU, as
    JAX's are on its CPU device;
  * the real ``torch.profiler`` on the CPU: ``--profile_steps A:B`` and
    ``--profile`` write Chrome traces under the telemetry directory that
    hold the run's ``fdt/`` labels and the step's operators, and the
    window's log lines (JAX ``test_profile_steps_window_produces_trace``).
"""

import json
import os

import pytest
import torch

from faster_distributed_training_tpu.utils import profiling as jprof
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.utils import profiling

_SILENT = lambda *_: None                                 # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", ["", "3:5", "7:7", "1:100", "5", "0:3",
                                  "5:3", "a:b", "3:", ":3", "2:3:4"])
def test_parse_profile_steps_matches_jax(spec):
    """JAX ``parse_profile_steps``: the same window or the same
    refusal."""
    try:
        want = jprof.parse_profile_steps(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            profiling.parse_profile_steps(spec)
        assert str(got.value) == str(e)
        return
    assert profiling.parse_profile_steps(spec) == want


def _drive(mod, window, k, start, n_end):
    """One run's dispatches (``k`` steps each from step ``start`` to
    ``n_end``) through a profiler of ``mod`` whose start and stop are
    recorders; returns (calls, started_at, stopped_at, fences, done)."""
    calls, fences = [], []
    p = mod.StepWindowProfiler(
        "/trace", *window, start_fn=lambda d: calls.append(("start", d)),
        stop_fn=lambda: calls.append(("stop",)), log=_SILENT)
    s = start
    while s < n_end:
        kk = min(k, n_end - s)
        p.before_dispatch(s, kk)
        s += kk
        p.after_dispatch(s, fence=lambda: fences.append(s))
    p.close()
    return calls, p.started_at, p.stopped_at, fences, p.done


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("case", ["inside", "resume_past", "resume_inside",
                                  "ends_early", "first_step"])
def test_step_window_decisions_match_jax(k, case):
    """JAX ``StepWindowProfiler``: the same decisions at K=1 and K=4."""
    window, start, end = {
        "inside": ((5, 8), 0, 16), "resume_past": ((3, 5), 12, 16),
        "resume_inside": ((3, 9), 4, 16), "ends_early": ((6, 100), 0, 12),
        "first_step": ((1, 1), 0, 8)}[case]
    got = _drive(profiling, window, k, start, end)
    want = _drive(jprof, window, k, start, end)
    assert got == want
    if case == "inside":
        # the window quantizes to the dispatches that hold steps 5..8
        assert got[1] == 4 and got[2] == 8
        assert got[3] == [8]            # one fence, at the close


def test_start_failure_disables_the_window():
    """JAX: a profiler that fails to start logs and disables itself."""
    lines = []

    def boom(_d):
        raise RuntimeError("no profiler")
    for mod in (profiling, jprof):
        p = mod.StepWindowProfiler("/t", 1, 2, start_fn=boom,
                                   stop_fn=lambda: None, log=lines.append)
        p.before_dispatch(0, 1)
        assert p.done and not p.active
    assert sum("could not start" in x for x in lines) == 2


def test_memory_is_none_on_the_cpu():
    """JAX ``peak_memory_bytes`` / ``memory_watermarks`` read the
    backend's memory stats, None on its CPU device; the port's read the
    CUDA allocator, None off a card."""
    assert profiling.peak_memory_bytes("cpu") is None
    assert profiling.memory_watermarks("cpu") is None
    assert jprof.memory_watermarks() is None
    if not torch.cuda.is_available():
        assert profiling.memory_watermarks() is None


def _cfg(tmp_path, **kw):
    return TrainConfig(model="transformer", dataset="synthetic",
                       num_classes=4, batch_size=8, seq_len=16, n_layers=1,
                       d_model=16, d_ff=32, n_heads=2, epochs=1,
                       subset_stride=64, precision="fp32", plot=False,
                       log_every=0, device="cpu",
                       checkpoint_dir=str(tmp_path), **kw)


def _names(path):
    with open(path) as f:
        trace = json.load(f)
    return {e.get("name", "") for e in trace["traceEvents"]}


@pytest.mark.parametrize("k", [1, 4])
def test_profile_steps_window_writes_a_trace(tmp_path, k):
    """``--profile_steps 3:5`` (K=1, and K=4: the window quantized to the
    dispatch holding steps 3..5 and the next) writes
    ``<telemetry_dir>/trace_steps_3_5/trace.json`` holding the step's
    operators; the log says where the window started and stopped."""
    lines = []
    out = cli.run_training(_cfg(tmp_path, profile_steps="3:5",
                                steps_per_dispatch=k), log=lines.append)
    path = os.path.join(out["telemetry_dir"], "trace_steps_3_5",
                        "trace.json")
    names = _names(path)
    assert any(n.startswith("aten::") for n in names)
    text = "\n".join(lines)
    if k == 1:
        assert "trace started before step 3" in text
        assert "trace stopped after step 5" in text
    else:
        assert "trace started before step 1" in text
        assert "trace stopped after step 8" in text
    prof = out["profiler"]
    assert prof.done and not prof.active and prof.device_events is None


def test_profile_writes_a_whole_run_trace(tmp_path):
    """``--profile``: the whole run's trace at
    ``<telemetry_dir>/profile/trace.json``, with the ``fdt/eval`` span's
    label; under ``--no_telemetry`` too (the trace was asked for)."""
    for tel in (True, False):
        d = tmp_path / str(tel)
        lines = []
        cli.run_training(_cfg(d, profile=True, telemetry=tel),
                         log=lines.append)
        path = os.path.join(str(d), "telemetry", "profile", "trace.json")
        assert "fdt/eval" in _names(path)
        assert any("whole-run trace" in x for x in lines)
        assert os.path.exists(os.path.join(str(d), "telemetry",
                                           "host_00000.jsonl")) == tel
