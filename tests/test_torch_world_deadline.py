"""The deadline of a rank world (``tests/torch_parallel_ranks.run``)."""

import multiprocessing
import time

import pytest

from tests import torch_parallel_ranks as ranks


def test_world_deadline_ends_a_hung_world(tmp_path, monkeypatch):
    """A rank world that never ends (one rank in a barrier the other never
    enters) is ended at its deadline, and ``run`` names the case; a process
    the world did not start is left running."""
    deadline = 10.0
    monkeypatch.setattr(ranks, "WORLD_DEADLINE_S", deadline)
    other = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(600,))
    other.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="'hang' .*10.0 s"):
            ranks.run("hang", 2, tmp_path)
        assert time.monotonic() - t0 < deadline + 10
        assert multiprocessing.active_children() == [other]
    finally:
        other.kill()
        other.join()
