"""The keep masks that the program's dropout applies, recorded while it runs,
so that the reference drops the same units without knowing how the program
draws them.

Inside a ``Recorder``, every training-mode call of
``torch.nn.functional.dropout`` (``nn.Dropout`` calls it too) and every
``Tensor.bernoulli_`` made from Python appends the keep mask of that site, in
the program's own shape, in call order. A dropout's mask is read from its
output: an element is kept where the output is not zero; where the input
itself is zero the output says nothing, and such an element counts as kept
(its value is zero on both sides; ``ambiguous`` counts them) and is left out
of the drop rate. A ``bernoulli_`` draw is the mask itself. The program's
values are untouched: each wrapper returns what the wrapped call returned.

Since the reference follows whatever masks the program applied, the masks are
also held to the configuration: ``Replay`` sums, over the sites the reference
took them for, the units dropped against those the configured rate would drop
(``drop_rate_gap``), so that a program that drops too few or too many units,
or none, reads not correct.

Masks are held as packed bits on the host, so that recording the check's
steps adds little to the device's peak.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class Packed:
    """A bool tensor as bits on the host (packed where it lies, in
    ``numpy.packbits``'s order), with the count of its units that say
    something (``counted``: all but the ambiguous) and of those kept."""

    def __init__(self, keep: torch.Tensor, counted: torch.Tensor | None = None):
        self.shape = tuple(keep.shape)
        self.counted = keep.numel() if counted is None else int(counted.sum())
        self.kept = int(keep.sum()) if counted is None else int((keep & counted).sum())
        flat = keep.reshape(-1).to(torch.uint8)
        pad = -flat.numel() % 8
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        weight = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=flat.device)
        self.bits = (flat.view(-1, 8) * weight).sum(1, dtype=torch.uint8).cpu().numpy()

    def unpack(self, device) -> torch.Tensor:
        n = int(np.prod(self.shape, dtype=np.int64))
        flat = np.unpackbits(self.bits, count=n).astype(bool)
        return torch.from_numpy(flat).reshape(self.shape).to(device)


class Recorder:
    """``with Recorder() as r:`` ... ``r.masks``: the keep masks of every
    dropout site met inside, in order (``Packed``)."""

    def __init__(self):
        self.masks: list[Packed] = []
        self.ambiguous = 0

    def __enter__(self) -> "Recorder":
        self._dropout, self._bernoulli = F.dropout, torch.Tensor.bernoulli_
        real_dropout, real_bernoulli = self._dropout, self._bernoulli

        def dropout(input, p=0.5, training=True, inplace=False):
            if not training or p == 0.0:
                return real_dropout(input, p, training, inplace)
            before = input.detach().clone() if inplace else input.detach()
            out = real_dropout(input, p, training, inplace)
            zero = before == 0
            self.ambiguous += int(zero.sum())
            self.masks.append(Packed((out.detach() != 0) | zero, ~zero))
            return out

        def bernoulli_(tensor, *args, **kwargs):
            out = real_bernoulli(tensor, *args, **kwargs)
            self.masks.append(Packed(out.detach() != 0))
            return out

        F.dropout = dropout
        torch.Tensor.bernoulli_ = bernoulli_
        return self

    def __exit__(self, *exc) -> None:
        F.dropout = self._dropout
        torch.Tensor.bernoulli_ = self._bernoulli


class Replay:
    """The recorded masks of one step of one rank handed out in order, as
    bool tensors on ``device`` (the reference's ``Masks`` takes them with
    ``take``)."""

    def __init__(self, masks: list[Packed], device):
        self.masks, self.device, self.used = masks, device, 0
        self.counted = self.kept = 0
        self.expected_kept = 0.0

    def peek_shape(self) -> tuple[int, ...]:
        if self.used >= len(self.masks):
            raise ValueError(f"the program applied {len(self.masks)} dropout masks in this step; the reference "
                             "wants more")
        return self.masks[self.used].shape

    def take(self, shape, p: float) -> torch.Tensor:
        """The next mask, for a site the reference drops at rate ``p`` (the
        reference checks its ``shape``)."""
        self.peek_shape()
        mask = self.masks[self.used]
        self.used += 1
        self.counted += mask.counted
        self.kept += mask.kept
        self.expected_kept += mask.counted * (1.0 - p)
        return mask.unpack(self.device)

    def finish(self) -> None:
        if self.used != len(self.masks):
            raise ValueError(f"the program applied {len(self.masks)} dropout masks in this step; the reference "
                             f"used {self.used}")


def drop_rate_gap(replays: list[Replay]) -> float:
    """|units dropped - units the configured rates drop| over the latter,
    summed over every mask the reference took."""
    counted = sum(r.counted for r in replays)
    dropped = counted - sum(r.kept for r in replays)
    expected = counted - sum(r.expected_kept for r in replays)
    return abs(dropped - expected) / max(expected, 1.0)
