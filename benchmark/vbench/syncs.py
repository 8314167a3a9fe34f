"""A counter of synchronising CUDA calls, copied from ``chip_smoke.py``
(``SyncCounter``, ``SYNC_WARNING``) at commit 2b93434."""

from __future__ import annotations

import warnings

import torch

SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncCounter:
    """Counts the synchronising CUDA calls made inside the block: the
    warnings ``torch.cuda.set_sync_debug_mode("warn")`` raises, one per call.
    Other warnings caught meanwhile are kept apart in ``other``."""

    def __enter__(self):
        self._rec = warnings.catch_warnings(record=True)
        self.caught = self._rec.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._rec.__exit__(*exc)
        self.sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in self.caught
                      if SYNC_WARNING in str(w.message)]
        self.other = sorted({f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}: {str(w.message)[:100]}"
                             for w in self.caught if SYNC_WARNING not in str(w.message)})
        self.count = len(self.sites)
        return False
