# The port's copy of pslite_tpu/cluster/__init__.py (it imports nothing of JAX).
"""Cluster-level control policies (docs/autopilot.md).

The scheduler already owns every sense (ClusterHistory, SLO watchdog,
trace attribution) and every actuator (routing epochs, elastic
join/decommission, snapshots, apply retune); this package holds the
policies that connect them without an operator in the loop.
"""

from .autopilot import Autopilot, Veto, parse_mode  # noqa: F401
