"""The port's command line (``python -m xbitops_tpu_torch``), mirroring
``tests/test_cli.py``: ``convert`` packs the JAX tests' AutoGPTQ checkpoint,
then ``generate --device cpu`` prints ``[id] [tokens] (reason)`` lines equal
to the JAX CLI's on the same directory, and on the AutoGPTQ directory itself,
and on the directory the JAX ``convert`` wrote; ``serve`` builds its endpoint.
``convert --tp 2`` then ``generate --tp 2`` (two gloo ranks, spawned) print
the tokens of ``--tp 1``, and so does ``generate --tp 2`` on the AutoGPTQ
directory; a ``--tp`` the heads do not split by, and ``bench`` on the CPU,
raise (``quantize`` is held by ``tests/test_torch_e2e_quantize.py``)."""

import subprocess
import sys

import pytest
import torch

import tests.test_io as tio
from xbitops_tpu.cli import main as jmain
from xbitops_tpu_torch.cli import main

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

GEN = ["--prompt", "5 9 2", "--prompt", "17 3 100 41 8", "--max-tokens", "4", "--slots", "2",
       "--max-seq-len", "32"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    class Factory:
        def mktemp(self, name):
            return tmp_path_factory.mktemp(name)

    d, _ = tio.ckpt_dir.__wrapped__(Factory())
    return d


def _lines(out: str):
    return [line for line in out.splitlines() if line.startswith("[")]


def test_convert_then_generate_equals_jax_cli(ckpt, tmp_path, capsys):
    out, jout = tmp_path / "packed", tmp_path / "packed_by_jax"
    assert main(["convert", "--ckpt", str(ckpt), "--out", str(out), "--device", "cpu"]) == 0
    assert (out / "manifest.json").exists() and (out / "config.json").exists()
    assert (out / "quantize_config.json").exists()
    assert jmain(["convert", "--ckpt", str(ckpt), "--out", str(jout)]) == 0
    capsys.readouterr()

    assert jmain(["generate", "--ckpt", str(jout), *GEN]) == 0
    want = _lines(capsys.readouterr().out)
    assert len(want) == 2 and all(line.endswith("(length)") for line in want)
    for d in (out, ckpt, jout):
        assert main(["generate", "--ckpt", str(d), "--device", "cpu", *GEN]) == 0
        assert _lines(capsys.readouterr().out) == want, d


def test_convert_then_generate_tp2_equals_tp1(ckpt, tmp_path, capfd):
    out = tmp_path / "packed_tp2"
    assert main(["generate", "--ckpt", str(ckpt), "--device", "cpu", *GEN]) == 0
    want = _lines(capfd.readouterr().out)
    assert len(want) == 2
    assert main(["convert", "--ckpt", str(ckpt), "--out", str(out), "--tp", "2",
                 "--device", "cpu"]) == 0
    assert '"tp": 2' in (out / "manifest.json").read_text()
    capfd.readouterr()
    for d in (out, ckpt):  # rank 0 prints, from a process of its own
        assert main(["generate", "--ckpt", str(d), "--tp", "2", "--device", "cpu", *GEN]) == 0
        assert _lines(capfd.readouterr().out) == want, d


def test_unported_options_and_bench_raise(ckpt, tmp_path):
    with pytest.raises(ValueError):  # 4 heads do not split over 3 ranks
        main(["convert", "--ckpt", str(ckpt), "--out", str(tmp_path / "p"), "--tp", "3",
              "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["bench"])


def test_module_entry_point_lists_the_subcommands():
    proc = subprocess.run([sys.executable, "-m", "xbitops_tpu_torch", "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for cmd in ("convert", "generate", "serve", "bench", "quantize"):
        assert cmd in proc.stdout


def test_serve_builds_its_endpoint(ckpt, monkeypatch):
    """``serve`` loads the checkpoint, builds the engine with ``--slots`` and
    ``--burst`` and serves until interrupted (here at once)."""
    from xbitops_tpu_torch.engine.server import ServingEndpoint

    seen = {}

    def interrupted(self):
        seen.update(slots=self.engine.slots, burst=self.engine.decode_burst, port=self.port)
        self._httpd.server_close()
        raise KeyboardInterrupt

    monkeypatch.setattr(ServingEndpoint, "serve_forever", interrupted)
    assert main(["serve", "--ckpt", str(ckpt), "--device", "cpu", "--port", "0", "--slots", "3",
                 "--burst", "2", "--max-seq-len", "32"]) == 0
    assert seen["slots"] == 3 and seen["burst"] == 2 and seen["port"] > 0
