"""Multi-device training over ``torch.distributed`` (port of
``deeprank2_tpu/parallel``): one process per rank, the collectives with
their transposes (``comm``), process groups (``cluster``), the
data-parallel step functions (``dp``), the edge-partitioned and block-sparse
graph-parallel forwards with their rings (``edge_partition``,
``blocksparse_partition``), the collective counts of one step
(``comm_shape``) and the spawner of the tests and the dry run (``launch``)."""
