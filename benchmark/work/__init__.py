"""Work counts of the configurations, from the published architectures'
shapes and the benchmark's own masks: never from the program's counters or
from the ATen ops that ran, so a roofline reads the same work whatever
implements it."""
