"""Fault injection for the zero-downtime chaos soak.

The soak's pass criterion is ACCOUNTING, not survival: every sample
either provably lands on a global shard or is attributed to a named
drop counter, every tier's conservation ledger balances, and the
cross-tier trace tree stays stitched across the fault.  The injector
here produces the faults; the ledger and trace surfaces
(``observe/``) produce the proof.
"""

from veneur_tpu_torch.chaos.injector import (InjectedWireDrop,
                                             WireFaultInjector,
                                             flap_member)

__all__ = ["InjectedWireDrop", "WireFaultInjector", "flap_member"]
