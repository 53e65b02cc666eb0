"""serve_mfu.batch: the CDAN forward's FLOPs (from its layer shapes) times the
images restored a second in the window, over 989 TFLOP/s, in %."""

from h100bench.metrics._shared import serve_mfu as read  # noqa: F401
