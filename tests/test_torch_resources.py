"""``tests/test_resources.py``, all 4 cases, against
the port's resource sets (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "resources")
