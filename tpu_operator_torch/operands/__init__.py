"""The operands the port's node agents run or call: the /dev/char links,
the runtime wire that keeps the CDI spec fresh, the driver container's
installer and its driver manager, the vfio manager and the sandbox
operands (vm-manager, vm-device-manager, kata-manager)."""
