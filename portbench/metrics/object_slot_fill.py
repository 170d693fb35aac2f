"""100 x the valid object tokens the served episodes need (the census) over
the object tokens the program sent through its pano encoder, its
`objects.slots` counter (portbench/objects.py, its own spans pass), in %."""

from portbench.objects import readings


def read(ctx):
    r = readings(ctx)
    return None if r is None else r.get("object_slot_fill")
