"""GJ core: potentials, elimination, GFJS (numpy copies), the torch engine and the facade."""
