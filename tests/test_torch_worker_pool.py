"""``tests/test_worker_pool.py``, all 4 cases, against
the port's worker pool (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "worker_pool")
