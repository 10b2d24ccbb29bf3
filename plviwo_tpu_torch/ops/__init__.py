"""L0 math substrate: Lie ops, camera models, Plücker lines, the MSCKF kernel."""
