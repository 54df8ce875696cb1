"""The interpreter's ``xp`` namespace over torch.

``interp._run(..., xp=)`` builds arrays with ``xp.asarray`` and
``xp.stack`` (items of ``takes``, chunks of a ``map`` of arity > 1,
``emits`` arrays). The jit backend runs firing functions with this
namespace, where the reference passes ``jax.numpy``: values become
tensors on the device of the values they come from, at the dtypes
``jnp.asarray`` would give them (frontend/eval._t).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch


def asarray(v: Any) -> torch.Tensor:
    from ziria_tpu_torch.frontend.eval import _t
    return _t(v)


def stack(vs: Sequence[Any]) -> torch.Tensor:
    from ziria_tpu_torch.frontend.eval import _ts
    return torch.stack(_ts(list(vs)))
