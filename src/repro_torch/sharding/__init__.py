"""Virtual mesh and the sharding rules the train-state layout needs."""
