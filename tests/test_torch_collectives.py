"""``tests/test_collectives.py``, both cases, against the port's
object-store collective group, which runs through an async coordinator
actor (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "collectives")
