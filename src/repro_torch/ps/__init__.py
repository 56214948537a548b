from .server import ParameterServer
from .worker import Worker
from .replica import ReplicaServer
from .async_trainer import AsyncTrainer, AsyncTrainResult

__all__ = ["ParameterServer", "Worker", "ReplicaServer", "AsyncTrainer",
           "AsyncTrainResult"]
