"""The operands the port's node agents run or call: the /dev/char links,
the VFIO group scan and the runtime wire that keeps the CDI spec fresh."""
