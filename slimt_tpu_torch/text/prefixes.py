"""Default English nonbreaking prefixes for sentence splitting.

The reference loads Moses-style prefix files shipped with each model
package (slimt/Splitter.cc:20-53) and has no built-in list. This
module provides a standard English set as a fallback so splitting
quality is reasonable when a package ships no ssplit file; a
package-provided file always takes precedence.

Format matches Moses nonbreaking_prefix files: one prefix per line,
`# NUMERIC_ONLY #` marks prefixes that only suppress breaks before
numbers.
"""

ENGLISH = "\n".join(
    # single letters (initials)
    [chr(c) for c in range(ord("A"), ord("Z") + 1)]
    + [
        # titles and honorifics
        "Adj", "Adm", "Adv", "Asst", "Bart", "Bldg", "Brig", "Bros",
        "Capt", "Cmdr", "Col", "Comdr", "Con", "Corp", "Cpl", "DR",
        "Dr", "Drs", "Ens", "Gen", "Gov", "Hon", "Hr", "Hosp", "Insp",
        "Lt", "MM", "MR", "MRS", "MS", "Maj", "Messrs", "Mlle", "Mme",
        "Mr", "Mrs", "Ms", "Msgr", "Op", "Ord", "Pfc", "Ph", "Prof",
        "Pvt", "Rep", "Reps", "Res", "Rev", "Rt", "Sen", "Sens", "Sfc",
        "Sgt", "Sr", "St", "Supt", "Surg",
        # misc abbreviations
        "v", "vs", "i.e", "rev", "e.g", "etc", "approx", "apt", "dept",
        # numeric-only: suppress a break only before a number
        "No # NUMERIC_ONLY #", "Art # NUMERIC_ONLY #",
        "pp # NUMERIC_ONLY #", "Nr # NUMERIC_ONLY #",
        "Nos # NUMERIC_ONLY #",
        "Jan # NUMERIC_ONLY #", "Feb # NUMERIC_ONLY #",
        "Mar # NUMERIC_ONLY #", "Apr # NUMERIC_ONLY #",
        "Jun # NUMERIC_ONLY #", "Jul # NUMERIC_ONLY #",
        "Aug # NUMERIC_ONLY #", "Sep # NUMERIC_ONLY #",
        "Oct # NUMERIC_ONLY #", "Nov # NUMERIC_ONLY #",
        "Dec # NUMERIC_ONLY #",
    ]
)
