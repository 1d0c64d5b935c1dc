"""``tests/test_local_mode.py``, all 17 cases, against
the port's local mode (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "local_mode")
