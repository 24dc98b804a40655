"""What each kernel launch of the traced window needed to move.

The two kernel wrappers of the port (``ops/bitprop.py``) are swapped,
through their public names, for spies that note each launch's shape and
its live frontier (counted on the device, read only after the window),
then call the wrapper. This costs a few small device operations a launch,
in traced runs only.
"""

from __future__ import annotations

from . import roofline


class LaunchSpy:
    def __init__(self, torch, bitprop):
        self.torch, self.bitprop = torch, bitprop
        self.bit: list = []
        self.dense: list = []
        self._orig = None

    def install(self) -> None:
        bp = self.bitprop
        bit, dense = bp.bit_or_matmul, bp.dense_or_matmul
        self._orig = (bit, dense)

        def bit_spy(a, vb, nb):
            self.bit.append((a.shape[0], a.shape[1], nb,
                             (vb[:nb] != 0).any(dim=0).sum()))
            return bit(a, vb, nb)

        def dense_spy(A, f):
            self.dense.append((A.shape[0], A.shape[1], f.shape[0],
                               (f != 0).any(dim=0).sum()))
            return dense(A, f)

        # the wrappers count their launches through their module names
        bit_spy.launches = bit.launches
        dense_spy.launches = dense.launches
        bp.bit_or_matmul, bp.dense_or_matmul = bit_spy, dense_spy

    def remove(self) -> None:
        if self._orig is None:
            return
        bp = self.bitprop
        spies = (bp.bit_or_matmul, bp.dense_or_matmul)
        bp.bit_or_matmul, bp.dense_or_matmul = self._orig
        for orig, spy in zip(self._orig, spies):
            orig.launches = spy.launches
        self._orig = None

    def totals(self) -> dict:
        """Per wrapper: launches and the summed least time (s)."""
        out = {}
        for name, rows, need in (
                ("bit_or_matmul", self.bit, self._bit_bound),
                ("dense_or_matmul", self.dense, self._dense_bound)):
            live = (self.torch.stack([r[3] for r in rows]).tolist()
                    if rows else [])
            out[name] = {"n": len(rows), "bound_s": sum(
                need(r, int(v)) for r, v in zip(rows, live))}
        return out

    @staticmethod
    def _bit_bound(r, live: int) -> float:
        n_dst, k, nb, _ = r
        return roofline.bound_s(roofline.bit_hop_bytes(n_dst, k, nb, live))

    @staticmethod
    def _dense_bound(r, live: int) -> float:
        n_dst, n_src, batch, _ = r
        return roofline.bound_s(
            roofline.dense_hop_bytes(n_dst, n_src, batch, live),
            roofline.dense_hop_ops(n_dst, batch, live))
