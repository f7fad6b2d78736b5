"""Launchers: train, serve, the mesh, the cell report (dryrun) and the
roofline / CIM sweep."""
