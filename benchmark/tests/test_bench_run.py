"""run.py end to end on the CPU at tiny sizes, through both drivers, with the
plain kernels: the result line, cells added by new files only, the faults the
check must catch, and the refusal without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, TINY_CELLS, add_tiny_cells, copy_checkout, tree_hashes

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cpu(root: Path, cell: str, trace: int, seconds: float = 3.0, seed: int = 3000000019):
    """run.main in a fresh interpreter whose ``benchmark`` is the copy at
    ``root``, on the CPU; returns (rc, last stdout line as JSON or None, stderr)."""
    code = ("import sys; from pathlib import Path; "
            f"sys.path.insert(0, {str(root)!r}); sys.path.append({str(REPO)!r}); "
            "from benchmark import run; "
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', "
            f"'{seconds}', '--trace', '{trace}'], device='cpu', root=Path({str(root)!r})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=root)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_run_prints_one_result_line(tiny_root, cell, trace):
    rc, line, err = run_cpu(tiny_root, cell, trace)
    assert rc == 0, err[-3000:]
    assert list(line)[: len(KEYS)] == KEYS and list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if trace:
        assert "busy_s" in line["device"] and "window_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in bench["end_to_end"]}
        assert not names & set(line["metrics"])
    else:
        e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        assert set(line["metrics"]) == {m["name"] for m in e2e}
        for m in e2e:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
            assert line["metrics"][m["name"]]["value"] > 0
    for name, c in line["check"].items():
        assert f"check {name} {c['value']} limit {c['limit']}" in err.splitlines()[-len(line["check"]):]


def test_cell_and_metric_added_by_new_files_only(tmp_path):
    """A configuration, a cell and a per-layer metric come in as new files and
    new BENCHMARK.json entries; no file that the benchmark has changes."""
    root = copy_checkout(tmp_path)
    before = tree_hashes(root)
    add_tiny_cells(root)
    metric = root / "benchmark" / "metrics" / "served_per_request.py"
    metric.write_text('"""Served tokens a request (a test metric)."""\n\n\ndef read(rec):\n'
                      '    return sum(len(r.tokens) for r in rec.requests) / len(rec.requests)\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(name="served_per_request", unit="tokens", better="higher",
                                   source="host_clock", layer="engine", moves="tokens_per_s",
                                   workloads=["tiny-moe.decode"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    after = tree_hashes(root)
    changed = [f for f, h in before.items() if after.get(f) != h and f != "BENCHMARK.json"]
    assert not changed
    rc, line, err = run_cpu(root, "tiny-moe.decode", 1)
    assert rc == 0, err[-3000:]
    assert line["metrics"]["served_per_request"]["value"] > 0


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
def test_check_fails_a_broken_timed_path(tiny_root, monkeypatch, capsys, fault):
    """The run's own check (the chip's look skipped) reads correct = false when
    the timed path is broken: a token altered where the engine produces it, or
    a decode step that leaves the cache as it was."""
    from benchmark import run
    from xbitops_tpu_torch.engine import engine as eng
    from xbitops_tpu_torch.models import llama

    if fault == "token_altered":
        sample = eng.Engine._sample

        def altered(self, logits, temps, greedy):
            return (sample(self, logits, temps, greedy) + 1) % logits.shape[-1]

        monkeypatch.setattr(eng.Engine, "_sample", altered)
    else:
        step = llama.decode_step

        def unchanged(model, tokens, cache, active=None, use_kernel=True):
            lengths = cache.lengths.clone()
            out = step(model, tokens, cache, active=active, use_kernel=use_kernel)
            cache.lengths.copy_(lengths)
            return out

        monkeypatch.setattr(llama, "decode_step", unchanged)
    for cell in sorted(TINY_CELLS):
        assert run.main(["--workload", cell, "--seed", "11", "--seconds", "2", "--trace", "0"],
                        device="cpu", root=tiny_root) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is False, (cell, line["check"])


def test_chat_tail_moves_with_the_program_speed(tiny_root, monkeypatch, capsys):
    """Below capacity the chat cell's end-to-end number is the tail: a program
    whose decode steps take 20 ms longer reads a longer ``latency_p95_ms``.
    One torch thread: on a shared CPU, many threads put the tiny cell above
    its capacity, where the tail follows the host's load and not the step."""
    import time

    import torch

    from benchmark import run
    from xbitops_tpu_torch.models import llama

    def p95():
        assert run.main(["--workload", "tiny-llama.chat", "--seed", "12", "--seconds", "3",
                         "--trace", "0"], device="cpu", root=tiny_root) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is True
        return line["metrics"]["latency_p95_ms"]["value"]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fast = p95()
        step = llama.decode_step

        def slow(*a, **k):
            time.sleep(0.02)
            return step(*a, **k)

        monkeypatch.setattr(llama, "decode_step", slow)
        assert p95() > 1.3 * fast
    finally:
        torch.set_num_threads(threads)


def test_refuses_without_a_card(tiny_root):
    """The measurement path takes no other device: no CUDA, no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny-llama.chat",
                        "--seed", "1", "--seconds", "1"], cwd=tiny_root, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    there is no program to run: no result."""
    root = copy_checkout(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mistral-7b.chat",
                        "--seed", "1", "--seconds", "1"], cwd=root, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.gpu
def test_a_cell_on_the_card(tmp_path):
    """The shortest cell at full size on the card: a correct result line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mistral-7b.chat",
                        "--seed", "3000000021", "--seconds", "5", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
