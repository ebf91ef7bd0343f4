"""The loops that drive a cell's traffic: a traffic file names one."""
