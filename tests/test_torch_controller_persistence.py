"""``tests/test_controller_persistence.py``, all 3 cases, against
the port's controller persistence (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "controller_persistence")
