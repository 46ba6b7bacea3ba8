"""One driver per entry point of the program: its set-up, its timed
unit, and the check of what the unit produced. A traffic mix names its
driver."""
