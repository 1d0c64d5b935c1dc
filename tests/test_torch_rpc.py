"""``tests/test_rpc.py``, all 27 cases, against
the port's RPC layer (loaded and renamed by ``tests/_torch_suites.py``).

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "rpc")
