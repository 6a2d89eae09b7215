"""epl-lint over the PyTorch port (port of
``easyparallellibrary_tpu/analysis/``): a static invariant checker for
the port's hard contracts — load once, zero implicit host syncs on hot
paths, the metric namespace schema, B/E span pairing, tracer/watchdog
lock discipline and device introspection only where it lives.

Run it with ``python -m easyparallellibrary_tpu_torch.analysis`` (or
``make lint-torch``); ``tests/test_torch_analysis.py`` keeps the port at
zero non-baselined findings.  The rule table is in ``rules.py``.
"""

from easyparallellibrary_tpu_torch.analysis.core import (  # noqa: F401
    Analyzer, Finding, apply_baseline, default_baseline_path,
    load_baseline, package_root, write_baseline)
from easyparallellibrary_tpu_torch.analysis.rules import (  # noqa: F401
    default_rules)
