"""Launch layer (port of ``repro/launch``): the production mesh as a layout
record, the sharding rules and the ``shard`` hook, the cell builders, and
the meta-device dry run."""
