"""One thread for torch in every process that runs the port's tests.

Every ``tests/test_torch_*.py`` imports this module at module level, so a
pytest process (each xdist worker too) caps torch's intra-op pool at one
thread while it collects, before any test runs. The suite runs several
workers side by side on one machine's CPUs; at torch's default (a pool as
wide as the machine in each worker, and in each process a test spawns)
the pools spin against each other, and a test then takes many times its
own time. Results do not depend on it: two runs that a test holds bit for
bit run in one process, at one thread count.

``single_thread_env`` is the environment to give a process that a test
starts with ``subprocess`` (the solver's CLI, a script), passed to it
explicitly. A gloo rank of ``torch_dist_cases.spawn`` (multiprocessing
takes no environment) sets ``SINGLE_THREAD`` in its own environment and
calls ``torch.set_num_threads(1)`` in its entry.
"""

import os

import torch

SINGLE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

torch.set_num_threads(1)


def single_thread_env(**extra: str) -> dict:
    """This process's environment with the thread caps and ``extra``."""
    return {**os.environ, **SINGLE_THREAD, **extra}
