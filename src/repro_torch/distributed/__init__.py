"""The distributed layer: the layout (``plan``: Topology, Mesh,
ShardingPlan with its ZeRO-1 moment specs; ``sharding``: the rules), the
collectives (``collectives``: float32 sums and maxima, reduce-scatters,
all-gathers, point to point, the int8 exchange and the Megatron autograd
pair), the GPipe schedule over the "pod" axis (``pipeline``), elastic
re-meshing and the resharding restore (``elastic``), spawned worlds of
ranks (``launch``) and fault injection (``fault``)."""
from . import fault  # noqa: F401
