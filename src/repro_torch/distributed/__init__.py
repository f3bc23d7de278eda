"""The distributed layer: the layout (``plan``: Topology, Mesh,
ShardingPlan; ``sharding``: the rules), the serving collectives
(``collectives``), elastic re-meshing (``elastic``), spawned worlds of
ranks (``launch``) and fault injection (``fault``).  Its training half
(ZeRO-1 specs, the int8 gradient exchange, pipeline stages, elastic
restore) waits for ROADMAP queue 1, item 2."""
from . import fault  # noqa: F401
