from .server import ParameterServer
from .worker import Worker
from .replica import ReplicaServer, promote_replica
from .async_trainer import AsyncTrainer, AsyncTrainResult
from .sync_trainer import SyncTrainer, allreduce_via_ps
from .stale_sync import StaleSyncSim, compare_ssp_mlfabric
from .pod_async import PodAsyncTrainer

__all__ = ["ParameterServer", "Worker", "ReplicaServer", "promote_replica",
           "AsyncTrainer", "AsyncTrainResult", "SyncTrainer",
           "allreduce_via_ps", "StaleSyncSim", "compare_ssp_mlfabric",
           "PodAsyncTrainer"]
