"""One module a model family, found by the ``model`` key of a configuration
file: its parameters, its reference forward, its FLOP count and the port's
class that runs it."""
