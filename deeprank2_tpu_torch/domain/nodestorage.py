"""Canonical HDF5 dataset names for node features.

This is the on-disk schema vocabulary; it matches the reference layout
(reference: deeprank2/domain/nodestorage.py) so HDF5 datasets produced by either
framework interoperate.

The port's copy of ``deeprank2_tpu/domain/nodestorage.py``: the HDF5 names are the
same byte for byte, so both packages read the same files.
"""

## main group
NODE = "node_features"

## metafeatures
NAME = "_name"
CHAINID = "_chain_id"
POSITION = "_position"

## atom core features
ATOMTYPE = "atom_type"
ATOMCHARGE = "atom_charge"
PDBOCCUPANCY = "pdb_occupancy"

## residue core features
RESTYPE = "res_type"
RESCHARGE = "res_charge"
POLARITY = "polarity"
RESSIZE = "res_size"
RESMASS = "res_mass"
RESPI = "res_pI"
HBDONORS = "hb_donors"
HBACCEPTORS = "hb_acceptors"

## variant residue features
VARIANTRES = "variant_res"
DIFFCHARGE = "diff_charge"
DIFFSIZE = "diff_size"
DIFFMASS = "diff_mass"
DIFFPI = "diff_pI"
DIFFPOLARITY = "diff_polarity"
DIFFHBDONORS = "diff_hb_donors"
DIFFHBACCEPTORS = "diff_hb_acceptors"

## conservation features
PSSM = "pssm"
INFOCONTENT = "info_content"
CONSERVATION = "conservation"
DIFFCONSERVATION = "diff_conservation"

## protein context features
RESDEPTH = "res_depth"
HSE = "hse"
SASA = "sasa"
BSA = "bsa"
SECSTRUCT = "sec_struct"

## inter-residue contacts (IRCs)
IRC_NONNON = "irc_nonpolar_nonpolar"
IRC_NONPOL = "irc_nonpolar_polar"
IRC_NONNEG = "irc_nonpolar_negative"
IRC_NONPOS = "irc_nonpolar_positive"
IRC_POLPOL = "irc_polar_polar"
IRC_POLNEG = "irc_polar_negative"
IRC_POLPOS = "irc_polar_positive"
IRC_NEGNEG = "irc_negative_negative"
IRC_NEGPOS = "irc_negative_positive"
IRC_POSPOS = "irc_positive_positive"
IRCTOTAL = "irc_total"

IRC_FEATURES = [
    IRC_NONNON,
    IRC_NONPOL,
    IRC_NONNEG,
    IRC_NONPOS,
    IRC_POLPOL,
    IRC_POLNEG,
    IRC_POLPOS,
    IRC_NEGNEG,
    IRC_POSPOS,
    IRC_NEGPOS,
    IRCTOTAL,
]
