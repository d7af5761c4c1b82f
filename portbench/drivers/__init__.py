"""The general drivers a traffic file names ("driver"): `stream` (a closed
loop of batches through the streamed round trip) and `train` (the graphed
train call fed by the loader's prefetch). Each reads its parameters from
the traffic file and the sizes from the configuration file."""
