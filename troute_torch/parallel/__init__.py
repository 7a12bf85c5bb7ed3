"""Multi-GPU routing on ``torch.distributed`` (port of
``troute_tpu/parallel``): the partition, the sharded drivers and the
process groups they run in."""

from troute_torch.parallel.partition import NetworkPartition, partition_network
from troute_torch.parallel.sharded_engine import route_sharded
from troute_torch.parallel.stepped_engine import route_sharded_stepped
