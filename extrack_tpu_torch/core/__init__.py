"""Tables and the plain likelihood engine."""
