"""The traffic: one generator, and a parameter file per mix."""
