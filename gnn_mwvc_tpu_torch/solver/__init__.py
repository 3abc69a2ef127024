"""The solver: ``pipeline.solve`` and its phase-1 scorers
(``static_score``, ``sharded_score``, ``quick``), the command lines and the
harnesses around them.  Each name is imported from its own module."""
