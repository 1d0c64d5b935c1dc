"""``tests/test_object_store.py``, all 6 cases, against
the port's object store (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.

The file's own fixture, ``private_shm_names``, names this process's
segments and segment-reuse pools under a prefix of its own. A store
charges every ``rtt-pool-*`` file on the host to its capacity (in the
reference too, with ``rt-pool-*``), so a pool of another cluster running
beside these tests would fill the 1 MiB store of ``test_spill_and_restore``
before its first object (ROADMAP, "Inconsistencies of the reference").
"""

import os

import pytest

from _torch_suites import load

load(globals(), "object_store")


@pytest.fixture(autouse=True)
def private_shm_names(monkeypatch):
    from ray_tpu_torch.core import object_store

    monkeypatch.setattr(object_store, "SHM_PREFIX", f"rtt-t{os.getpid()}-")
