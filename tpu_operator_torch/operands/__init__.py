"""The operands' helpers that the port's node agents call: the /dev/char
links and the VFIO group scan."""
