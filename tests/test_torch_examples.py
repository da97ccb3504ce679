"""The example twins (``examples/torch_*.py``) against the JAX package's
examples: each twin runs with ``--device cpu`` in this process while the
reference example runs in a subprocess (``JAX_PLATFORMS=cpu``, a time
limit, killed on overrun), and their printed lines must agree once what
cannot agree is taken out:

  * measurements (the observation stack's ns per scheduler decision) and
    temporary paths;
  * the collective bytes of ``stencil_locality``: the reference counts them
    in XLA HLO, the twin counts what each gloo rank hands to
    ``torch.distributed`` (divergence P11: no masked wrap-around pair), so
    the twin's bytes are held to the paper's claim, contiguous < scattered,
    and to the counts of its exchange, not to the reference's numbers.

Everything else (tasks, rounds, local fractions, steals, prefill tokens,
percentiles, timelines, storms, replays, controller snapshots, derived
JSON) is the schedule, which does not depend on weights or timing, and is
compared line for line.  The serving twins' cases are in
``test_torch_examples_serving.py`` (so no one test worker carries all the
reference runs).
"""
import os
import pathlib
import re
import runpy
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE_LIMIT_S = 180

_TMP = re.compile(r"/\S*?/([\w.-]+\.trace\.jsonl)")
_NS = re.compile(r"^  (\w+)\s+\d+\s+\((\d+) calls\)$")
_WROTE = re.compile(r"^wrote \S+ ")
_COLL = re.compile(r"collective=\d+ KiB/dev")


def normalize(text: str, example: str) -> list[str]:
    lines = []
    for line in text.splitlines():
        line = _TMP.sub(r"<tmp>/\1", line)
        line = _NS.sub(r"  \1 <ns> (\2 calls)", line)
        line = _WROTE.sub("wrote <out> ", line)
        if example == "stencil_locality":
            if line.startswith(("bytes handed", "-> locality schedule moves")):
                continue
            line = _COLL.sub("collective=<bytes>", line)
        lines.append(line)
    return lines


def start_reference(example: str, args: list[str]) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{example}.py"), *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_reference(proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=REFERENCE_LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the reference example ran past {REFERENCE_LIMIT_S} s and was killed")
    assert proc.returncode == 0, err[-4000:]
    return out


def run_twin(example: str, args: list[str], capsys, monkeypatch) -> tuple[str, object]:
    """The twin in this process; returns its output and ``main``'s value."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src") + os.pathsep +
                       os.environ.get("PYTHONPATH", ""))
    monkeypatch.setattr(sys, "argv", [f"examples/torch_{example}.py", *args])
    mod = runpy.run_path(str(ROOT / "examples" / f"torch_{example}.py"), run_name="twin")
    capsys.readouterr()
    ns = mod["main"].__code__.co_varnames[:mod["main"].__code__.co_argcount]
    kw = {}
    if "device" in ns:
        kw["device"] = "cpu"
    if "ranks" in ns:
        kw["ranks"] = 8
    result = mod["main"](**kw)
    return capsys.readouterr().out, result


def compare(example, ref_args, twin_args, capsys, monkeypatch):
    proc = start_reference(example, ref_args)
    try:
        twin_out, result = run_twin(example, twin_args, capsys, monkeypatch)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    ref_out = finish_reference(proc)
    assert normalize(twin_out, example) == normalize(ref_out, example)
    return twin_out, ref_out, result


def test_obs_timeline(tmp_path, capsys, monkeypatch):
    """The printed lines, and the exported timeline byte for byte."""
    ref_file, twin_file = tmp_path / "ref.perfetto-trace", tmp_path / "twin.perfetto-trace"
    proc = start_reference("obs_timeline", ["--out", str(ref_file)])
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["examples/torch_obs_timeline.py", "--out", str(twin_file)])
    runpy.run_path(str(ROOT / "examples" / "torch_obs_timeline.py"), run_name="__main__")
    twin_out = capsys.readouterr().out
    ref_out = finish_reference(proc)
    assert normalize(twin_out, "obs_timeline") == normalize(ref_out, "obs_timeline")
    assert twin_file.read_bytes() == ref_file.read_bytes()


@pytest.mark.parametrize("example", ["spec_policies", "run_experiment", "trace_stencil"])
def test_schedule_lines(example, capsys, monkeypatch):
    compare(example, [], [], capsys, monkeypatch)


def test_stencil_locality_eight_gloo_ranks(capsys, monkeypatch):
    out, _, result = compare("stencil_locality", [], [], capsys, monkeypatch)
    assert re.search(r"-> locality schedule moves \d+x fewer bytes", out)
    plane = 4 * 48 * 64
    sent = [b["contiguous"].get("sent", 0) for b in result["bytes"]]
    gathered = [b["scattered"]["gathered"] for b in result["bytes"]]
    assert sent == [plane] + [2 * plane] * 6 + [plane]
    assert gathered == [8 * 2 * 2 * plane] * 8
    assert max(sent) < min(gathered)
    assert result["unequal_to_whole_sweep"] == [0, 0]
    assert result["k1_launches"] == [{"contiguous": 0, "scattered": 0}] * 8   # CPU: plain


def test_more_ranks_than_cards_raises():
    """``--device cuda`` (the default) takes one NCCL rank a card: asking for
    more raises (on a host without a card, for want of one); the twin never
    carries on on the CPU."""
    import torch

    mod = runpy.run_path(str(ROOT / "examples" / "torch_stencil_locality.py"), run_name="twin")
    with pytest.raises(RuntimeError, match="no CUDA device|cards"):
        mod["main"](ranks=torch.cuda.device_count() + 1, device="cuda")
