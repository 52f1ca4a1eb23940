"""Reference weights → port tensors.

:func:`params_from_numpy` takes the reference ``Model.init_params`` pytree
with every leaf already converted to ``np.ndarray`` (the caller does the
conversion; this module never sees a JAX object) and returns the port's
parameter dict with the same names, layout and stacked layer axis, so a
port model and a reference model can run on identical weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 leaves
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy leaves → same nesting of tensors on ``device``
    (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return tensor_from_numpy(tree, device, dtype)
