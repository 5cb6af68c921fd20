"""Amino-acid records and lookups (import-path parity with the reference's
deeprank2/domain/aminoacidlist.py; the implementation lives in
molstruct/aminoacid.py as column tables)."""

from deeprank2_tpu_torch.molstruct.aminoacid import (  # noqa: F401
    alanine,
    amino_acids,
    amino_acids_by_code,
    amino_acids_by_letter,
    amino_acids_by_name,
    arginine,
    asparagine,
    aspartate,
    convert_aa_nomenclature,
    cysteine,
    glutamate,
    glutamine,
    glycine,
    histidine,
    isoleucine,
    leucine,
    lysine,
    methionine,
    phenylalanine,
    proline,
    pyrrolysine,
    selenocysteine,
    serine,
    threonine,
    tryptophan,
    tyrosine,
    valine,
)
