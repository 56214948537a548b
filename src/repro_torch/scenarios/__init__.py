"""Pre-built dynamic-cluster scenarios (see ``repro.core.scenario``)."""

from .library import (aggregator_outage, burst_loss, churn, congestion_loss,
                      congestion_wave, degraded_monitor, flash_crowd,
                      paper_dynamic_cluster, pod_stress, server_failover)

__all__ = ["churn", "aggregator_outage", "flash_crowd", "congestion_wave",
           "burst_loss", "congestion_loss", "degraded_monitor",
           "pod_stress", "server_failover", "paper_dynamic_cluster"]
