"""``tests/test_observability.py``, all 6 cases, against
the port's metrics and state API (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "observability")
