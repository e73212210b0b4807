"""control.py at a test size on the CPU: one line a seed with the program's
readings and the controls' (the chip run at each cell's size sets the
limits, PERF.md)."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import REPO


def test_control_reads_the_program_and_the_controls(tiny_root):
    code = ("import sys; "
            f"sys.path.insert(0, {str(tiny_root)!r}); sys.path.append({str(REPO)!r}); "
            "from benchmark import control; "
            "sys.exit(control.main(['--workload', 'tiny-llama.chat', '--seeds', '21,22', "
            "'--seconds', '2', '--device', 'cpu']))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=tiny_root)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert [x["seed"] for x in lines] == [21, 22]
    for x in lines:
        assert x["tokens"] > 0 and x["requests"] >= 3
        for k in ("served", "control", "control_int4_kv"):
            assert set(x[k]) == {"max", "mean", "p99", "agree", "correct"}
        assert x["served"]["correct"] is True
        # float8 activations part from the float32 reference more than bf16 does
        assert x["control"]["mean"] > x["served"]["mean"]
        assert x["control"]["agree"] < x["served"]["agree"]
