"""Performance model of the port: the closed-form analytical model
(``sim.analytical``, with the instruction table ``sim.isa``) that the
drift monitor compares measured tick stages against."""
