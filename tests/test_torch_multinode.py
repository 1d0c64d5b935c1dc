"""``tests/test_multinode.py``, all 3 cases, against
the port's simulated multi-node cluster (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "multinode")
