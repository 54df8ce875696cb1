"""Static analysis of the port's own tree: the `lint` subcommand
(counterpart of ziria_tpu/analysis/).

    python -m ziria_tpu_torch.analysis [paths...]     # pure AST
    python -m ziria_tpu_torch lint [paths...]         # the same, via the CLI
    from ziria_tpu_torch.analysis import lint_paths   # library / test gate

The rules (rules.py) are the reference's, retargeted to eager torch and
the port's kernel wrappers; the test gate is tests/test_torch_lint.py
(zero findings over ``ziria_tpu_torch/``).
"""

from ziria_tpu_torch.analysis.engine import (Finding,  # noqa: F401
                                             LintResult, lint_paths,
                                             lint_source)
from ziria_tpu_torch.analysis.rules import (ALL_RULES,  # noqa: F401
                                            NOT_RUN, RULES_BY_ID)
