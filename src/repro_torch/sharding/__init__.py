"""Device meshes and placement rules (port of ``repro.sharding``: the mesh
and the bank, fleet and gateway rules)."""
