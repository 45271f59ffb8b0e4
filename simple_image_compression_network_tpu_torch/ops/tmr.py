"""Triple-modular-redundancy checker: fault-tolerance capability parity.

The PyTorch counterpart of the JAX package's ``ops/tmr.py``.  The reference
triplicates output channels and votes 2-of-3 with a 2-bit error flag
(``tmrcheck.hpp:76-161``, integrated as ``ConvLayer_Batch_TMR``,
``convlayer.h:185-220``): run a layer with channel-triplicated weights,
vote elementwise across the 3 replicas, and classify disagreements.

Error flag (tmrcheck.hpp): 0 = all replicas agree; 1 (LSB) = one replica
disagreed somewhere (corrected by majority); 2 (MSB) = some element had all
three replicas distinct (uncorrectable).  The flag is an int32 0-d tensor on
the input's device, so the vote never waits for the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import conv_int


def triplicate_weights(w: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[O,kx,ky,I] -> [3O,kx,ky,I] with each output channel repeated 3x
    (channel-interleaved, matching REDF=3 folding in convlayer.h:208)."""
    return (torch.as_tensor(w).repeat_interleave(3, dim=0),
            torch.as_tensor(b).repeat_interleave(3, dim=0))


def tmr_check(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """De-triplicate and vote: y (..., 3C) -> (voted (..., C), errflag ()).

    Majority per element; when no two replicas agree the vote takes
    replica a."""
    c3 = y.shape[-1]
    if c3 % 3:
        raise ValueError(f"{c3} channels are not three replicas")
    r = y.reshape(y.shape[:-1] + (c3 // 3, 3))
    a, b, c = r[..., 0], r[..., 1], r[..., 2]
    ab, ac, bc = a == b, a == c, b == c
    voted = torch.where(ab | ac, a, torch.where(bc, b, a))
    none_agree = ~(ab | ac | bc)
    one_bad = (~(ab & ac) & ~none_agree).any().to(torch.int32)
    all_bad = none_agree.any().to(torch.int32)
    return voted, one_bad | (all_bad << 1)


def conv2d_int8_tmr(params_w: torch.Tensor, params_b: torch.Tensor,
                    x: torch.Tensor, *, stride: int = 2, padding: int = 2,
                    fault_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvLayer_Batch_TMR: the triplicated conv layer (``conv_int.
    conv2d_int8``) and the vote.  ``fault_mask`` (the triplicated output's
    shape) is XORed into the output between compute and vote, to inject
    bit flips."""
    wt, bt = triplicate_weights(params_w, params_b)
    y = conv_int.conv2d_int8(x, wt.to(x.device), bt.to(x.device),
                             stride=stride, padding=padding)
    if fault_mask is not None:
        y = conv_int.wrap_to_int8(
            y.to(torch.int32)
            ^ torch.as_tensor(fault_mask).to(device=y.device,
                                              dtype=torch.int32))
    return tmr_check(y)
