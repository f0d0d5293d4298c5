"""Tools of the port: benchmark table, zram simulation, corpus, timing and movebench."""
