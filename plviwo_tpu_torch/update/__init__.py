"""L3 measurement row builders: camera points, lines, wheel."""
