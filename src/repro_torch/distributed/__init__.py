"""Sharding rules on a torch DeviceMesh (port of `repro.distributed`)."""
