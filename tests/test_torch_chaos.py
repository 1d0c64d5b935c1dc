"""``tests/test_chaos.py`` against the port: a task graph and restartable
actors completing correctly while ``WorkerKiller`` SIGKILLs workers under
injected RPC failures, and ``find_worker_pids`` scoped to one cluster
(loaded and renamed by ``tests/_torch_suites.py``). Its trainer-under-
node-chaos case stays ``slow``, as in the reference.

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "chaos")
