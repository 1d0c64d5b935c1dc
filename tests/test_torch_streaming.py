"""``tests/test_streaming.py`` against the port's streaming generators
(loaded and renamed by ``tests/_torch_suites.py``): 11 of its 12 cases.
``test_streaming_consumes_before_completion`` is left out because
``test_torch_runtime.py::test_streaming_generator_consumed_before_completion``
already holds it.

No statement differs from the reference apart from the package's name.
"""

from _torch_suites import load

load(globals(), "streaming", drop=("test_streaming_consumes_before_completion",))
