"""``tests/test_cancel.py``, all 7 cases, against
the port's cancellation (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "cancel")
