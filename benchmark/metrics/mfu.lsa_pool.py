"""mfu.lsa_pool: % of the card's peak that the LSA steps' model operations
take over the window of the cells that batch from a pool of rays (as
``mfu.lsa``)."""
from benchmark.metrics._common import mfu as read
