"""Input generators: frozen copies of the port's synthetic scenes and mask
rules, so that later changes to the program cannot move the yardstick."""
