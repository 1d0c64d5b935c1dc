"""``tests/test_cluster.py``, all 14 cases, against
the port's cluster (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "cluster")
