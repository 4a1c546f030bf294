"""One torch intra-op thread for a test module: import
``one_torch_thread`` into it (an autouse, module-scoped fixture).

The port's CPU paths call torch from several threads at once (the
batch runner's sieve on the host pool beside its interval waves, the
scheduler's executor beside its ring's drain thread), and on the CPU
each call starts a team of intra-op threads. Beside the suite's other
worker processes that oversubscribes the cores many times over and
the port's files ran up to ten times slower than alone. One intra-op
thread, here and in the CLI subprocesses a module starts, keeps them
proportionate; nothing a test checks depends on the thread count."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    saved_env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(saved)
        if saved_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved_env
